"""Step-based trainer, port of train/trainer.py for one device.

The model arrives with its weights on its device; the Trainer draws the
training noise from its own ``torch.Generator`` there (seeded by ``seed``),
steps through ``parallel.make_train_step`` (forward, loss, backward,
optional global-norm clipping, the optimizer, optional EMA) and logs
through ``MetricsLogger`` (TensorBoard event files and JSONL):

  * every ``scalar_interval`` steps, each 0-dim metric of the step as
    ``losses/<name>``, fetched in one device-to-host transfer, and the
    learning rate when a scheduler runs;
  * every ``val_interval`` steps, the validation loss, bpp and PSNR of the
    deployable weights (the EMA when there is one), one transfer a batch;
  * every ``log_interval`` / ``img_interval`` steps, the JAX Trainer's
    diagnostic catalogue: histograms of latents, likelihoods, entropies and
    entropy parameters, dead channels, mixture usage, paired images,
    heatmaps and the bottleneck's CDF/PMF. Its forward draws noise from a
    generator seeded from (seed, step), never from the training generator,
    so runs with other log intervals train on the same noise.

Checkpoints (``utils.checkpoint``, one file) hold the model's and the
optimizer's state dicts, the training generator's state, the EMA, the step
and the plateau controller; they are written every ``checkpoint_interval``
steps and at the end. ``resume=True`` restores the latest and extends
``max_steps`` by the restored step. With ``preemption_safe``, SIGTERM or
SIGINT during ``train()`` lets the current step finish, writes a checkpoint
and returns.

Schedulers set ``lr`` in every param group of the optimizer, so any torch
optimizer takes them (JAX needs ``optax.inject_hyperparams`` for that and
raises without it; nothing here can be missing).

With ``mesh`` (``parallel.make_mesh``) the Trainer runs data parallel, one
process a device, as the JAX Trainer runs across processes: every rank runs
this same script, its loaders yield its share of each global batch
(``data.shard_for_process``), and the step averages the gradients
(``make_train_step(mesh=...)``, which also broadcasts the weights from rank
0). Rank 0 alone logs (the others get a ``NullLogger``) and writes
checkpoints; every rank enters ``save_checkpoint`` and waits at a barrier
after the write, and on resume every rank restores the same file, so the
checkpoint must sit where all ranks read it. The stop decision of
``preemption_safe`` and the validation sums are all-reduced, so every rank
stops at the same step and the plateau scheduler sees one loss. The
histogram and image diagnostics run only in a one-rank run, as in JAX.
With a "model" dimension the checkpoints hold the whole optimizer state,
gathered from the ranks' shards. A world of more than one rank without a
mesh raises: each rank would train its own replica.

A variable-rate model (one with ``levels``, ``models.gained``) trains at a
level drawn each step (``make_train_step(levels=...)``); validation pins
the middle level and its lambda, so the plateau scheduler follows one
objective. The diagnostic forward and ``eval_params``' users run the
default level, as in the JAX Trainer.
"""

import math
import signal
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from neural_image_compression_tpu_torch.parallel.mesh import process_count, process_index
from neural_image_compression_tpu_torch.parallel.train_step import (
    batch_to_device, make_train_step,
)
from neural_image_compression_tpu_torch.train.loss import rd_loss as default_rd_loss
from neural_image_compression_tpu_torch.train.metrics_logger import (
    MetricsLogger, NullLogger, host_scalars,
)
from neural_image_compression_tpu_torch.train.schedulers import ReduceLROnPlateau, cosine_lr
from neural_image_compression_tpu_torch.utils.checkpoint import (
    checkpoint_exists, restore_checkpoint, save_checkpoint,
)

_LN2 = math.log(2.0)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _diag_seed(seed: int, step: int) -> int:
    """The diagnostic forward's seed at ``step``, apart from the training
    generator's stream (the counterpart of JAX's fold_in)."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])


class Trainer:
    def __init__(self, model, train_loader: Iterable, val_loader: Optional[Iterable] = None,
                 rd_loss: Optional[Callable] = None, lambda_val: float = 0.005,
                 learning_rate: float = 1e-4,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 scheduler: Optional[str] = None, max_steps: int = 10000, resume: bool = False,
                 log_interval: Optional[int] = None, img_interval: Optional[int] = None,
                 val_interval: Optional[int] = None, checkpoint_interval: Optional[int] = None,
                 scalar_interval: int = 1, preemption_safe: bool = False,
                 log_dir: str = "runs/experiment",
                 checkpoint_path: Optional[str] = "./checkpoints/checkpoint.pt",
                 seed: int = 0, ema_decay: Optional[float] = None,
                 clip_grad_norm: Optional[float] = None, mesh=None):
        """optimizer: a torch optimizer over ``model.parameters()``; None
        builds Adam(learning_rate, betas (0.9, 0.999), eps 1e-8), optax's
        Adam. clip_grad_norm clips in the step (``make_train_step``) and,
        as in the JAX Trainer, goes only with the default optimizer.
        scheduler: None, "cosine" (after every step, towards 1e-5 at
        max_steps) or "plateau" (on the validation loss). mesh: a
        ``parallel.make_mesh`` mesh over every rank, or None on one
        process."""
        if scheduler not in (None, "cosine", "plateau"):
            raise ValueError(f"scheduler must be None, 'cosine' or 'plateau', got {scheduler!r}")
        if optimizer is not None and clip_grad_norm is not None:
            raise ValueError("pass either a custom optimizer or clip_grad_norm, not both")
        self._process_count = process_count()
        self._is_main_process = process_index() == 0
        if self._process_count > 1 and mesh is None:
            raise ValueError(
                f"a run of {self._process_count} processes needs a mesh spanning them "
                "(parallel.make_mesh()): without one, each process would train an "
                "independent replica on its own batches")
        self.model = model
        self.device = next(model.parameters()).device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.rd_loss = rd_loss or default_rd_loss
        self.lambda_val = lambda_val
        self.base_lr = learning_rate
        self.max_steps = max_steps
        self.step = 0
        self.seed = seed
        # scalars default to every step (the reference's catalogue); each
        # logged step costs one device-to-host transfer
        self.scalar_interval = max(1, scalar_interval)
        self.log_interval = log_interval or max(1, int(max_steps / 200))
        self.img_interval = img_interval or max(1, int(max_steps / 25))
        self.val_interval = val_interval or max(1, int(max_steps / 200))
        self.checkpoint_interval = checkpoint_interval
        self.checkpoint_path = checkpoint_path
        self._preemption_safe = preemption_safe
        self._stop_requested = False
        self._train_iter = iter(train_loader)

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = optimizer or torch.optim.Adam(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        levels = getattr(model, "levels", None)
        self._train_step = make_train_step(model, self.optimizer, self.rd_loss, lambda_val,
                                           ema_decay=ema_decay, clip_grad_norm=clip_grad_norm,
                                           levels=levels, mesh=mesh)
        self._tensor_parallel = self._train_step.tensor_parallel
        if levels:
            self._val_kwargs = {"level": len(levels) // 2}
            self._val_lambda = float(levels[len(levels) // 2])
        else:
            self._val_kwargs, self._val_lambda = {}, lambda_val
        # name -> tensor, updated in place by the step; None without EMA
        self.ema_params = self._train_step.ema_params

        self.scheduler = scheduler
        self.plateau = ReduceLROnPlateau(learning_rate) if scheduler == "plateau" else None

        if resume and checkpoint_path is not None and checkpoint_exists(checkpoint_path):
            self.load_checkpoint()
        # only rank 0 writes TensorBoard and JSONL
        self.logger = (MetricsLogger(log_dir, purge_step=self.step)
                       if self._is_main_process else NullLogger())

    # ------------------------------------------------------------------
    def _next_batch(self):
        try:
            return next(self._train_iter)
        except StopIteration:
            self._train_iter = iter(self.train_loader)
            try:
                return next(self._train_iter)
            except StopIteration:
                raise ValueError(
                    "train_loader yielded no batches (empty dataset or "
                    "batch_size > dataset size with drop_remainder)") from None

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def current_lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @property
    def eval_params(self):
        """The weights to deploy and evaluate, name -> tensor: the EMA when
        enabled, else the live state dict. Validation uses these, so the
        plateau scheduler tracks the deployable model."""
        return self.ema_params if self.ema_params is not None else self.model.state_dict()

    # ------------------------------------------------------------------
    def save_checkpoint(self):
        # every rank enters (gathering tensor-parallel optimizer state is a
        # collective); rank 0 writes and the others wait for it at the barrier
        if self._tensor_parallel is not None:
            optimizer_state = self._tensor_parallel.optimizer_state_dict(self.optimizer)
        else:
            optimizer_state = self.optimizer.state_dict()
        state = {"model": self.model.state_dict(),
                 "optimizer": optimizer_state,
                 "rng": self.generator.get_state()}
        if self.ema_params is not None:
            state["ema_params"] = self.ema_params
        aux = {"step": int(self.step)}
        if self.plateau is not None:
            aux["plateau"] = self.plateau.state_dict()
        if self._is_main_process:
            save_checkpoint(self.checkpoint_path, state, aux)
            print(f"Checkpoint saved at step {self.step} -> {self.checkpoint_path}")
        if self._process_count > 1:
            dist.barrier()

    def load_checkpoint(self):
        # on the host: load_state_dict copies the weights and moves Adam's
        # moments to the parameters' device, but Adam keeps its step counts
        # (and the generator its state) on the CPU. The optimizer's state
        # dict carries the scheduled learning rate.
        state, aux = restore_checkpoint(self.checkpoint_path, map_location="cpu")
        self.model.load_state_dict(state["model"])
        if self._tensor_parallel is not None:
            self._tensor_parallel.load_optimizer_state_dict(self.optimizer, state["optimizer"])
        else:
            self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["rng"])
        if self.ema_params is not None:
            source = state.get("ema_params")
            if source is None:
                print("checkpoint has no ema_params: EMA restarts from the restored params")
                source = dict(self.model.named_parameters())
            with torch.no_grad():
                for name, e in self.ema_params.items():
                    e.copy_(source[name])
        self.step = int(aux["step"]) if aux else 0
        if self.plateau is not None and aux and "plateau" in aux:
            self.plateau.load_state_dict(aux["plateau"])
        # resume extends the run by the restored step (Trainer.py:70)
        self.max_steps += self.step
        print(f"Checkpoint loaded -> Resuming from step {self.step}")

    # ------------------------------------------------------------------
    def train(self):
        """Train up to max_steps (or a stop signal); returns the model."""
        previous = {}
        if self._preemption_safe:
            def _handler(signum, frame):
                self._stop_requested = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, _handler)
        try:
            self._loop()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        self.logger.flush()
        if self.checkpoint_path is not None:
            self.save_checkpoint()
        return self.model

    def _loop(self):
        while self.step < self.max_steps:
            batch = torch.as_tensor(self._next_batch(), device=self.device)
            metrics = self._train_step(batch, self.generator)

            if self.step % self.scalar_interval == 0:
                self._log_scalars(metrics)

            if self.val_loader is not None and self.step % self.val_interval == 0:
                val_loss = self._validate()
                if self.plateau is not None:
                    self._set_lr(self.plateau.step(val_loss))

            if self.scheduler == "cosine":
                self._set_lr(cosine_lr(self.step + 1, self.base_lr, self.max_steps))

            if self.scheduler is not None and self.step % self.scalar_interval == 0:
                self.logger.scalar("train/learning_rate", self.current_lr(), self.step)

            # per-example diagnostics of one rank's rows would mislabel a
            # multi-rank run: as in JAX, only a one-rank run draws them
            if self._process_count == 1 and (self.step % self.log_interval == 0
                                             or self.step % self.img_interval == 0):
                self._diagnostics(batch)

            if (self.checkpoint_interval and self.checkpoint_path is not None
                    and self.step > 0 and self.step % self.checkpoint_interval == 0):
                self.save_checkpoint()

            self.step += 1
            if self._should_stop():
                print(f"stop requested: checkpointing at step {self.step}")
                break

    def _should_stop(self) -> bool:
        """The stop decision, one for all ranks: a signal can reach some
        ranks only, and a rank that left the loop alone would wait at the
        checkpoint's barrier while the others step."""
        if self._process_count == 1 or not self._preemption_safe:
            return self._stop_requested
        flag = torch.tensor([int(self._stop_requested)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    # ------------------------------------------------------------------
    def _log_scalars(self, metrics):
        for k, v in host_scalars(metrics).items():
            self.logger.scalar(f"losses/{k}", v, self.step)

    def _eval_forward(self, x: torch.Tensor, **kwargs):
        if self.ema_params is None:
            return self.model(x, training=False, **kwargs)
        return functional_call(self.model, self.ema_params, (x,), {"training": False, **kwargs})

    @torch.no_grad()
    def _validate(self) -> float:
        total_loss = bpp = psnr = 0.0
        n = 0
        for imgs in self.val_loader:
            x = batch_to_device(imgs, self.device)
            m = self.rd_loss(self._eval_forward(x, **self._val_kwargs), x, self._val_lambda)
            m = host_scalars({k: m[k] for k in ("loss", "bpp_total", "psnr")})
            total_loss += m["loss"]
            bpp += m["bpp_total"]
            psnr += m["psnr"]
            n += 1
        if self._process_count > 1:
            # each rank validates its share: sum over the ranks, so that every
            # rank (and its plateau scheduler) sees one validation loss
            sums = torch.tensor([total_loss, bpp, psnr, float(n)], dtype=torch.float64,
                                device=self.device)
            dist.all_reduce(sums)
            total_loss, bpp, psnr, n = sums.tolist()
        if n == 0:
            return math.inf
        self.logger.scalar("validation/validation_loss", total_loss / n, self.step)
        self.logger.scalar("validation/validation_bpp", bpp / n, self.step)
        self.logger.scalar("validation/validation_psnr", psnr / n, self.step)
        return total_loss / n

    @torch.no_grad()
    def _diagnostics(self, batch: torch.Tensor):
        x = batch_to_device(batch, self.device)
        gen = torch.Generator(device=self.device).manual_seed(_diag_seed(self.seed, self.step))
        out = self.model(x, training=True, generator=gen)
        streams = self._latent_streams(out)
        if self.step % self.log_interval == 0:
            self._log_histograms(out)
            for name in streams:
                self._log_channel_activity(out, name)
            self._log_entropy_params(out)
        if self.step % self.img_interval == 0:
            self._log_paired_images(x, out)
            for name in streams:
                self._log_entropy_heatmap(out, name)
                self._log_latent_heatmap(out, name)
            self._log_entropy_cdf(out, "z")

    @staticmethod
    def _latent_streams(out):
        """Latent stream names present in a model-out dict."""
        return [n for n in ("y", "y1", "y2", "z") if f"logp_{n}" in out]

    def _log_histograms(self, out):
        pairs = [("latents/y", "y"), ("latents/y_hat", "y_in"),
                 ("latents/z", "z"), ("latents/z_hat", "z_in"),
                 ("probability/logp_y", "logp_y"), ("probability/logp_z", "logp_z"),
                 ("probability/p_y", "p_y"), ("probability/p_z", "p_z")]
        for tag, key in pairs:
            if key in out:
                self.logger.histogram(tag, _host(out[key]), self.step)
        for name in self._latent_streams(out):
            logp = _host(out[f"logp_{name}"])
            self.logger.histogram(f"entropy/{name}", -logp / _LN2, self.step)
            per_comp = -logp.sum(axis=(1, 2)) / _LN2  # NHWC: sum spatial -> (B, C)
            self.logger.histogram(f"entropy/{name}_per_component", per_comp, self.step)
            self.logger.scalar(f"probability/logp_{name}_mean", logp.mean(), self.step)
            self.logger.scalar(f"probability/p_{name}_mean",
                               _host(out[f"p_{name}"]).mean(), self.step)
            self.logger.scalar(f"entropy/entropy_{name}_mean", (-logp / _LN2).mean(), self.step)

    def _log_channel_activity(self, out, name="y"):
        """Dead-channel count by entropy."""
        logp = _host(out["logp_" + name])
        avg_bits_per_c = (-logp / _LN2).mean(axis=(0, 1, 2))  # [C]
        dead = float((avg_bits_per_c < 1e-4).sum())
        self.logger.scalar(f"activity/{name}_dead_channels_by_entropy", dead, self.step)

    def _log_entropy_params(self, out):
        # suffix "" = joint models; "1"/"2" = scalable layers
        for sfx in ("", "1", "2"):
            if f"mu{sfx}" in out and f"sigma{sfx}" in out:
                self.logger.histogram(f"entropy_params/mu{sfx}", _host(out[f"mu{sfx}"]),
                                      self.step)
                self.logger.histogram(f"entropy_params/sigma{sfx}",
                                      _host(out[f"sigma{sfx}"]), self.step)
            if f"weights{sfx}" in out:
                w = _host(out[f"weights{sfx}"])  # (B, H, W, K, M)
                self.logger.histogram(f"entropy_params/weights{sfx}", w, self.step)
                self.logger.histogram(f"entropy_params/mus{sfx}", _host(out[f"mus{sfx}"]),
                                      self.step)
                self.logger.histogram(f"entropy_params/sigmas{sfx}",
                                      _host(out[f"sigmas{sfx}"]), self.step)
                used = float((w > 1e-4).sum(axis=-2).mean())
                self.logger.scalar(f"entropy_params/used_components_mean{sfx}", used,
                                   self.step)

    def _log_paired_images(self, x, out, max_samples: int = 4):
        n = min(max_samples, x.shape[0])
        imgs = np.clip(_host(x[:n]), 0, 1)
        recon = np.clip(_host(out["x_hat"][:n]), 0, 1)
        rows = [np.concatenate([imgs[i], recon[i]], axis=1) for i in range(n)]  # side by side
        self.logger.image("comparison/paired", np.concatenate(rows, axis=0), self.step)

    @staticmethod
    def _select_high_entropy_channel(logp0: np.ndarray) -> int:
        return int(logp0.sum(axis=(0, 1)).argmin())  # highest entropy = lowest logp

    def _log_entropy_heatmap(self, out, name="y"):
        logp = _host(out["logp_" + name][0])
        ch = self._select_high_entropy_channel(logp)
        ent = -logp[:, :, ch] / _LN2
        rng = ent.max() - ent.min()
        self.logger.image(f"heatmaps/quantized_{name}_entropy",
                          (ent - ent.min()) / (rng + 1e-12), self.step)

    def _log_latent_heatmap(self, out, name="y"):
        ch = self._select_high_entropy_channel(_host(out["logp_" + name][0]))
        hm = _host(out[name][0])[:, :, ch]
        rng = hm.max() - hm.min()
        self.logger.image(f"heatmaps/latent_{name}_heatmap",
                          (hm - hm.min()) / (rng + 1e-12), self.step)

    def _log_entropy_cdf(self, out, name="z", num_points: int = 200):
        """Factorized-bottleneck CDF/PMF curves for the low-, median- and
        high-entropy channels."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # matplotlib is optional
            return
        bottleneck = getattr(self.model, "factorized_entropy_model", None)
        if f"logp_{name}" not in out or bottleneck is None:
            return
        logp = _host(out[f"logp_{name}"][0])  # (H, W, C)
        ent_per_ch = -logp.sum(axis=(0, 1)) / _LN2
        order = np.argsort(ent_per_ch)
        chans = [int(order[0]), int(order[len(order) // 2]), int(order[-1])]

        zvals = _host(out[name][0])
        lo = zvals.min() - 3 * zvals.std()
        hi = zvals.max() + 3 * zvals.std()
        xs = np.linspace(lo, hi, num_points).astype(np.float32)
        pts = torch.from_numpy(xs).to(self.device)
        cdf_all = _host(bottleneck.grid_cdf(pts))
        pmf_all = _host(bottleneck.grid_pmf(pts))

        fig, ax = plt.subplots(1, 1, figsize=(6, 3.5))
        for ch in chans:
            zc = zvals[:, :, ch]
            ax.axvspan(zc.min(), zc.max(), alpha=0.15)
            ax.plot(xs, cdf_all[ch], linewidth=1.5,
                    label=f"ch {ch} ({ent_per_ch[ch]:.2f} bits)")
        ax.set_title("Factorized bottleneck CDF (per channel)")
        ax.set_ylim(0, 1)
        ax.legend(fontsize=8)
        self.logger.figure("bottleneck/cdf", fig, self.step)
        plt.close(fig)

        fig, ax = plt.subplots(1, 1, figsize=(6, 3.5))
        for ch in chans:
            ax.plot(xs, pmf_all[ch], linewidth=1.5,
                    label=f"ch {ch} ({ent_per_ch[ch]:.2f} bits)")
        ax.set_title("Factorized bottleneck PMF")
        ax.legend(fontsize=8)
        self.logger.figure("bottleneck/pmf", fig, self.step)
        plt.close(fig)
