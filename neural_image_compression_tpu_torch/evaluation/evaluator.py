"""Kodak-style evaluation harness, port of evaluation/evaluator.py.

CompressionEvaluator: a batch-by-batch eval loop of the model's eval
forward on its device; metrics MSE(255), PSNR(RGB), MS-SSIM(RGB), PSNR(Y,
BT.601) and MS-SSIM(Y) of clamped reconstructions; bpp aggregation;
side-by-side sample plots; high-entropy-channel maps; a results file in the
reference's format. ``evaluate_codec`` codes every image into a real
bitstream and reports the measured rate beside the analytic one.

'BPP' is the true total (y and z). 'BPP(reference_reported)' repeats the
reference's field, the mean of bpp_y alone, so results can be held against
its published artifact; 'BPP(y)' and 'BPP(z)' give the split.

``params`` (e.g. the Trainer's ``eval_params``, an EMA) is a dict name ->
tensor that the forward uses in place of the model's own parameters,
through ``torch.func.functional_call``. Scalars of one image come to the
host in one transfer. The matplotlib figures are saved to files.
"""

import copy
import math
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from neural_image_compression_tpu_torch.coding.refine import make_refiner
from neural_image_compression_tpu_torch.data.datasets import pad_to_multiple
from neural_image_compression_tpu_torch.evaluation.msssim import ms_ssim, rgb_to_luma
from neural_image_compression_tpu_torch.evaluation.viz import render_panel_grid
from neural_image_compression_tpu_torch.parallel.train_step import batch_to_device
from neural_image_compression_tpu_torch.train.loss import rd_loss as default_rd_loss
from neural_image_compression_tpu_torch.train.metrics_logger import host_scalars

_LN2 = math.log(2.0)


def normalize_map(x: np.ndarray, method: str = "minmax") -> np.ndarray:
    x = x.astype(np.float32)
    if method == "minmax":
        return (x - x.min()) / (x.max() - x.min() + 1e-12)
    if method == "std":
        return (x - x.mean()) / (x.std() + 1e-12)
    return x


def compute_metrics(orig: torch.Tensor, recon: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Distortion metrics on [0,1] NHWC images, 0-dim tensors on their
    device."""
    orig = orig.float()
    recon = recon.float()
    mse_rgb = torch.mean((orig - recon) ** 2)
    psnr_rgb = 10.0 * torch.log10(1.0 / mse_rgb)
    msssim_rgb = ms_ssim(recon, orig, data_range=1.0)
    y_orig = rgb_to_luma(orig)
    y_recon = rgb_to_luma(recon)
    mse_y = torch.mean((y_orig - y_recon) ** 2)
    psnr_y = 10.0 * torch.log10(1.0 / mse_y)
    msssim_y = ms_ssim(y_recon, y_orig, data_range=1.0)
    return {
        "MSE(255)": mse_rgb * 255.0 ** 2,
        "PSNR(RGB)": psnr_rgb,
        "MS-SSIM(RGB)": msssim_rgb,
        "PSNR(Y)": psnr_y,
        "MS-SSIM(Y)": msssim_y,
    }


def _mean_of(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: float(np.mean([m[k] for m in rows])) for k in rows[0]}


class CompressionEvaluator:
    def __init__(self, model, dataloader, lambda_val: float,
                 save_dir: Optional[str] = "./eval_results",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        self.params = params
        self.dataloader = dataloader
        self.lambda_val = lambda_val
        self.device = next(model.parameters()).device
        if save_dir is not None:  # None = metrics only (no artifacts/plots)
            os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir

    rgb_to_luma = staticmethod(rgb_to_luma)
    compute_metrics = staticmethod(compute_metrics)

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The eval forward (rounded latents, no autograd) with ``params``."""
        if self.params is None:
            return self.model(x, training=False)
        return functional_call(self.model, self.params, (x,), {"training": False})

    def _refine_model(self):
        """The model with ``params`` in place, for latent refinement, which
        calls its submodules one by one."""
        if self.params is None:
            return self.model
        model = copy.deepcopy(self.model)
        model.load_state_dict(self.params, strict=False)
        return model

    @torch.no_grad()
    def evaluate(self, rd_loss_fn: Optional[Callable] = None
                 ) -> Tuple[Dict[str, float], List[np.ndarray], List[np.ndarray]]:
        rd_loss_fn = rd_loss_fn or default_rd_loss
        total_metrics = []
        bpp_y_values, bpp_z_values, bpp_total_values = [], [], []
        imgs_list, recon_list = [], []

        for imgs in self.dataloader:
            x = batch_to_device(imgs, self.device)
            out = self._forward(x)
            results = rd_loss_fn(out, x, self.lambda_val)
            recon = torch.clamp(out["x_hat"], 0.0, 1.0)
            scalars = dict(compute_metrics(x, recon))
            scalars.update(bpp_y=results["bpp_y"], bpp_z=results["bpp_z"],
                           bpp_total=results["bpp_total"])
            scalars = host_scalars(scalars)
            bpp_y_values.append(scalars.pop("bpp_y"))
            bpp_z_values.append(scalars.pop("bpp_z"))
            bpp_total_values.append(scalars.pop("bpp_total"))
            total_metrics.append(scalars)
            imgs = np.asarray(imgs)
            imgs_list.append(imgs[0] if imgs.ndim == 4 else imgs)
            recon_list.append(recon[0].cpu().numpy())

        if not total_metrics:
            raise ValueError("evaluation dataloader yielded no images "
                             "(empty/misnamed data_dir?)")
        avg = _mean_of(total_metrics)
        avg["BPP"] = float(np.mean(bpp_total_values))          # the true total
        avg["BPP(y)"] = float(np.mean(bpp_y_values))
        avg["BPP(z)"] = float(np.mean(bpp_z_values))
        avg["BPP(reference_reported)"] = avg["BPP(y)"]         # the reference's field

        print("\n--- Evaluation Results ---")
        for k, v in avg.items():
            print(f"{k}: {v:.6f}")
        return avg, imgs_list, recon_list

    def evaluate_codec(self, codec, refine_steps: int = 0,
                       refine_lambda: float = None, refine_lr: float = 1e-3,
                       **compress_kwargs) -> Dict[str, float]:
        """Real-bitstream evaluation: compress -> decompress every image of
        every batch with the given codec (e.g. ``coding.JointARCodec``) and
        report the measured bpp (the stream's bytes) next to the analytic
        rate of the eval forward, plus the distortion of the decoded image.
        compress_kwargs go to codec.compress (e.g. n_streams=8).

        refine_steps > 0: encode-time latent refinement (coding.refine;
        refine_lambda is required: pass the model's training lambda). The
        refined latents are coded with codec.compress_latents; decode does
        not change, so the measured bpp is a true end-to-end number."""
        total_metrics = []
        real_bpps, analytic_bpps = [], []
        refiner = None
        if refine_steps:
            if refine_lambda is None:
                raise ValueError("refine_steps > 0 requires refine_lambda "
                                 "(use the model's training lambda)")
            refiner = make_refiner(self._refine_model(), refine_lambda, steps=refine_steps,
                                   lr=refine_lr)

        for imgs in self.dataloader:
            imgs = np.asarray(imgs)
            h, w = imgs.shape[1:3]
            # every image of the batch goes through the codec: a batch-N
            # loader must not shrink the evaluated set
            for b in range(imgs.shape[0]):
                img = imgs[b:b + 1]
                if refiner is not None:
                    xf = img.astype(np.float32)
                    if img.dtype == np.uint8:
                        xf /= 255.0
                    # pad as compress does (64, or the factorized prior's 16); the
                    # keywords fit every codec's compress_latents, the
                    # factorized one's (y_q, img_h, img_w, z_q=None) too
                    y_q, z_q, _ = refiner(pad_to_multiple(xf, codec.MULTIPLE))
                    data = codec.compress_latents(y_q[0], z_q=z_q[0], img_h=h, img_w=w,
                                                  **compress_kwargs)
                else:
                    data = codec.compress(img, **compress_kwargs)
                x_hat = codec.decompress(data)
                real_bpps.append(len(data) * 8.0 / (h * w))
                with torch.no_grad():
                    x = batch_to_device(img, self.device)
                    out = self._forward(x)
                    # the analytic rate of every logp_* stream of the model
                    bits = sum(-torch.sum(v) for k, v in out.items()
                               if k.startswith("logp_")) / _LN2
                    scalars = host_scalars(dict(
                        compute_metrics(x, torch.from_numpy(x_hat).to(self.device)),
                        bits=bits))
                analytic_bpps.append(scalars.pop("bits") / (h * w))
                total_metrics.append(scalars)

        if not total_metrics:
            raise ValueError("evaluation dataloader yielded no images "
                             "(empty/misnamed data_dir?)")
        avg = _mean_of(total_metrics)
        avg["BPP(bitstream)"] = float(np.mean(real_bpps))
        avg["BPP(analytic)"] = float(np.mean(analytic_bpps))
        avg["bitstream_overhead"] = avg["BPP(bitstream)"] / avg["BPP(analytic)"] - 1.0
        print("\n--- Codec Evaluation Results ---")
        for k, v in avg.items():
            print(f"{k}: {v:.6f}")
        return avg

    # -- visualization -------------------------------------------------
    # Every figure goes through viz.render_panel_grid; maps are shown in
    # their true value range with per-panel colorbars.

    @torch.no_grad()
    def plot_samples(self, imgs_list, recon_list, rd_loss_fn=None, n: int = 3,
                     seed: Optional[int] = None):
        """Per-image original-vs-reconstruction figures annotated with the
        coded size; saved to save_dir."""
        rd_loss_fn = rd_loss_fn or default_rd_loss
        rng = random.Random(seed)
        indices = rng.sample(range(len(imgs_list)), min(n, len(imgs_list)))
        paths = []
        for idx in indices:
            x = batch_to_device(np.asarray(imgs_list[idx])[None], self.device)
            r = rd_loss_fn(self._forward(x), x, self.lambda_val)
            rate = host_scalars({"bpp": r["bpp_total"], "bits": r["bits_total"]})
            nbytes = math.ceil(rate["bits"] / 8)
            row = [("original", np.asarray(imgs_list[idx])),
                   (f"reconstruction — {nbytes} B, {rate['bpp']:.4f} bpp",
                    np.asarray(recon_list[idx]))]
            paths.append(render_panel_grid(
                [row], os.path.join(self.save_dir, f"sample_{idx}.png"), panel=4.0))
        return paths

    @staticmethod
    def _busiest_channel(logp: np.ndarray) -> int:
        """Channel spending the most bits (argmax of mean -logp)."""
        return int(logp.reshape(-1, logp.shape[-1]).mean(axis=0).argmin())

    @torch.no_grad()
    def plot_high_entropy_channel(self, imgs_list, seed: Optional[int] = None):
        """Latent / entropy-parameter maps for the busiest channel, K=1 and
        K>1 layouts."""
        rng = random.Random(seed)
        idx = rng.randint(0, len(imgs_list) - 1)
        img = np.asarray(imgs_list[idx])[None]
        out = {k: v[0].float().cpu().numpy() for k, v in self._forward(
            batch_to_device(img, self.device)).items() if isinstance(v, torch.Tensor)}

        logp_y, logp_z = out["logp_y"], out["logp_z"]
        c = self._busiest_channel(logp_y)
        cz = self._busiest_channel(logp_z)
        # the quantized latents (y_in/z_in): logp/mu/sigma describe round(y),
        # so the residual panels must not carry the rounding error of y
        y_c = out.get("y_in", out["y"])[:, :, c]
        bits_y = -logp_y[:, :, c] / _LN2
        bits_z = -logp_z[:, :, cz] / _LN2
        hyper_row = [(f"hyper z[{cz}]", out.get("z_in", out["z"])[:, :, cz]),
                     (f"hyper bits[{cz}]", bits_z)]

        if "mu" in out and "sigma" in out:
            mu = out["mu"][:, :, c]
            sigma = out["sigma"][:, :, c]
            rows = [[("input", img[0]),
                     (f"y[{c}]", y_c),
                     ("mu", mu),
                     ("sigma", sigma),
                     ("(y-mu)/sigma", (y_c - mu) / (sigma + 1e-12)),
                     (f"bits[{c}]", bits_y)] + hyper_row]
        elif "weights" in out:
            w = out["weights"][:, :, :, c]   # (H, W, K)
            mus = out["mus"][:, :, :, c]
            sigmas = out["sigmas"][:, :, :, c]
            mix_mu = (w * mus).sum(axis=-1)
            mix_var = (w * (sigmas ** 2 + mus ** 2)).sum(axis=-1) - mix_mu ** 2
            mix_sigma = np.sqrt(np.clip(mix_var, 1e-9, None))
            rows = [[(f"w[{k}]", w[:, :, k]),
                     (f"mu[{k}]", mus[:, :, k]),
                     (f"sigma[{k}]", sigmas[:, :, k]),
                     (f"(y-mu[{k}])/sigma[{k}]",
                      (y_c - mus[:, :, k]) / (sigmas[:, :, k] + 1e-12)),
                     (f"y[{c}]", y_c)]
                    for k in range(w.shape[-1])]
            rows.append([("input", img[0]),
                         ("mixture mu", mix_mu),
                         ("mixture sigma", mix_sigma),
                         ("(y-mix mu)/mix sigma", (y_c - mix_mu) / mix_sigma),
                         (f"bits[{c}]", bits_y)] + hyper_row)
        else:
            return None

        return render_panel_grid(
            rows, os.path.join(self.save_dir, f"high_entropy_channel_{idx}.png"),
            suptitle=f"busiest latent channel c={c}")

    def save_results(self, metrics: Dict[str, float], nb_steps: int, caption: str = ""):
        """The reference's results file, byte for byte."""
        path = os.path.join(self.save_dir,
                            f"eval_results_{self.lambda_val}_lambda_" + caption + ".txt")
        with open(path, "w") as f:
            f.write(f"Lambda: {self.lambda_val}\n")
            f.write(f"Trained for: {nb_steps} steps\n")
            for k, v in metrics.items():
                f.write(f"{k}: {v:.6f}\n")
        print(f"Results saved to {path}")
        return path
