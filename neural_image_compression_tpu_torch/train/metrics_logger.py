"""Metrics and observability sinks, port of train/metrics_logger.py.

  * TensorBoardSink: native TensorBoard event files (scalars, histograms,
    images, matplotlib figures) through tensorboard's own EventFileWriter
    and protos, imported when the sink is made. ``purge_step`` writes a
    SessionLog START event, so a resumed run replaces what followed it.
  * JsonlSink: append-only JSONL of scalar metrics.
  * MetricsLogger multiplexes to both; without tensorboard it writes the
    JSONL alone. NullLogger drops everything.

Sinks take host values. ``host_scalars`` brings a dict of 0-dim tensors
to the host in one device-to-host transfer.
"""

import io
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def host_scalars(metrics: Dict[str, object]) -> Dict[str, float]:
    """The 0-dim entries of ``metrics`` as Python floats. Tensors come to
    the host together: one stack on their device and one copy, not one sync
    per value. Entries with more than one element are left out."""
    tensors, out = {}, {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                tensors[k] = v
        elif np.ndim(v) == 0:
            out[k] = float(v)
    if tensors:
        values = torch.stack([v.detach().float() for v in tensors.values()]).cpu().tolist()
        out.update(zip(tensors, values))
    return {k: out[k] for k in metrics if k in out}


class JsonlSink:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def scalar(self, tag: str, value, step: int):
        v = float(value)
        if v != v or v in (float("inf"), float("-inf")):
            v = repr(v)  # "nan"/"inf" strings keep every line valid JSON
        self._f.write(json.dumps({"step": int(step), "tag": tag,
                                  "value": v}) + "\n")

    def histogram(self, tag, values, step):  # not persisted in jsonl
        pass

    def image(self, tag, img, step):
        pass

    def figure(self, tag, fig, step):
        pass

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class TensorBoardSink:
    def __init__(self, log_dir: str, purge_step: Optional[int] = None):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.event_file_writer import EventFileWriter

        self._event_pb2 = event_pb2
        self._summary_pb2 = summary_pb2
        os.makedirs(log_dir, exist_ok=True)
        self._writer = EventFileWriter(log_dir)
        if purge_step is not None:
            ev = event_pb2.Event(
                wall_time=time.time(), step=int(purge_step),
                session_log=event_pb2.SessionLog(status=event_pb2.SessionLog.START))
            self._writer.add_event(ev)

    def _emit(self, summary, step: int):
        ev = self._event_pb2.Event(wall_time=time.time(), step=int(step), summary=summary)
        self._writer.add_event(ev)

    def scalar(self, tag: str, value, step: int):
        s = self._summary_pb2.Summary()
        s.value.add(tag=tag, simple_value=float(value))
        self._emit(s, step)

    def histogram(self, tag: str, values, step: int, bins: int = 64):
        values = np.asarray(values, np.float64).reshape(-1)
        # drop non-finite values: np.histogram raises on a NaN/inf range,
        # which would end the run at the logging step where it diverges
        values = values[np.isfinite(values)]
        if values.size == 0:
            return
        counts, edges = np.histogram(values, bins=bins)
        h = self._summary_pb2.HistogramProto(
            min=float(values.min()), max=float(values.max()),
            num=int(values.size), sum=float(values.sum()),
            sum_squares=float(np.square(values).sum()),
            bucket_limit=edges[1:].tolist(), bucket=counts.tolist())
        s = self._summary_pb2.Summary()
        s.value.add(tag=tag, histo=h)
        self._emit(s, step)

    def image(self, tag: str, img, step: int):
        """img: (H, W) or (H, W, C) float [0,1] or uint8."""
        from PIL import Image

        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        s = self._summary_pb2.Summary()
        s.value.add(tag=tag, image=self._summary_pb2.Summary.Image(
            height=img.shape[0], width=img.shape[1], colorspace=3,
            encoded_image_string=buf.getvalue()))
        self._emit(s, step)

    def figure(self, tag: str, fig, step: int):
        """Log a matplotlib figure as a PNG image."""
        from PIL import Image

        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100)
        buf.seek(0)
        img = np.asarray(Image.open(buf).convert("RGB"))
        self.image(tag, img, step)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


class MetricsLogger:
    """Multiplexes scalar/histogram/image/figure events to all sinks."""

    def __init__(self, log_dir: str, purge_step: Optional[int] = None,
                 tensorboard: bool = True, jsonl: bool = True):
        self.sinks = []
        if jsonl:
            self.sinks.append(JsonlSink(os.path.join(log_dir, "metrics.jsonl")))
        if tensorboard:
            try:
                self.sinks.append(TensorBoardSink(log_dir, purge_step))
            except ImportError:  # tensorboard is optional: JSONL alone
                pass

    def scalar(self, tag, value, step):
        for s in self.sinks:
            s.scalar(tag, value, step)

    def scalars(self, metrics: Dict[str, object], step: int, prefix: str = ""):
        """Every 0-dim entry of ``metrics``, fetched in one transfer."""
        for k, v in host_scalars(metrics).items():
            self.scalar(prefix + k, v, step)

    def histogram(self, tag, values, step):
        for s in self.sinks:
            s.histogram(tag, values, step)

    def image(self, tag, img, step):
        for s in self.sinks:
            s.image(tag, img, step)

    def figure(self, tag, fig, step):
        for s in self.sinks:
            s.figure(tag, fig, step)

    def flush(self):
        for s in self.sinks:
            s.flush()

    def close(self):
        for s in self.sinks:
            s.close()


class NullLogger:
    """A MetricsLogger that writes nothing."""

    def scalar(self, tag, value, step):
        pass

    def scalars(self, metrics, step, prefix=""):
        pass

    def histogram(self, tag, values, step, bins=64):
        pass

    def image(self, tag, img, step):
        pass

    def figure(self, tag, fig, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass
