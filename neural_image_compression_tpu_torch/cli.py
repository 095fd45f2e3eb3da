"""Single CLI entry point of the PyTorch/CUDA port, port of cli.py.

Usage (``nic-torch`` once the package is installed):
  python -m neural_image_compression_tpu_torch.cli preprocess --input_dir ... --output_dir ...
  python -m neural_image_compression_tpu_torch.cli download-coco --out_dir ... --n_images 1000
  python -m neural_image_compression_tpu_torch.cli train --config cfg.json [--train_dir ...]
  python -m neural_image_compression_tpu_torch.cli eval --config cfg.json --data_dir kodak/
  python -m neural_image_compression_tpu_torch.cli compress --config cfg.json --image in.png --out out.nic
  python -m neural_image_compression_tpu_torch.cli decompress --config cfg.json --bitstream out.nic --out rec.png
  python -m neural_image_compression_tpu_torch.cli export --config cfg.json --out model.pt2

The subcommands and flags are the JAX package's, with one more: the
subcommands that run a model take ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions), and ``export`` takes it in place of
``--platforms``. Configs, checkpoints' roles and stream files are the JAX
package's: a stream file is a 2-byte little-endian meta length, the JSON
meta, then the codec's bytes. Checkpoints are the port's Trainer's
(``utils/checkpoint.py``).
"""

import argparse
import json
import os
import sys

import torch

from neural_image_compression_tpu_torch.config import Config, build_model


def _load_config(path) -> Config:
    if path:
        # an explicitly named config that does not exist must be a hard
        # error: silently falling back to defaults would train/eval a wrong
        # model and could clobber the default checkpoint path
        if not os.path.exists(path):
            sys.exit(f"config file not found: {path}")
        with open(path) as f:
            return Config.from_json(f.read())
    return Config()


def _device(args) -> torch.device:
    """--device, refused where it names a CUDA device and there is none
    (the port's entry points never fall back to the CPU unasked)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def _build(cfg: Config, args):
    """The config's model on --device, weights drawn from cfg.train.seed
    (what a run without a checkpoint serves)."""
    return build_model(cfg.model, device=_device(args), seed=cfg.train.seed)


def _restore_params(model, cfg: Config):
    """Load the checkpoint at cfg.train.checkpoint_path into the model, its
    EMA weights where the run kept them, and return the loaded state (name
    -> tensor). Without a checkpoint the model keeps its seeded weights."""
    from neural_image_compression_tpu_torch.utils.checkpoint import (
        checkpoint_exists, restore_raw,
    )

    path = cfg.train.checkpoint_path
    if path and checkpoint_exists(path):
        raw = restore_raw(path, map_location=next(model.parameters()).device)
        # a checkpoint carries ema_params only when the run trained with
        # EMA — those are its deploy weights, so eval/compress prefer them
        ema = "ema_params" in raw
        state = {**raw["model"], **raw["ema_params"]} if ema else raw["model"]
        model.load_state_dict(state)
        print(f"restored {'EMA ' if ema else ''}params from {path}")
        return state
    print("WARNING: no checkpoint found, using random init")
    return model.state_dict()


def _materialize_level(cfg, model, args):
    """Variable-rate (gained*) configs: fold the gain vectors at --level into
    the boundary convolutions and continue with the matching fixed-rate model
    — the codec, evaluator, and serving export all run unchanged on it.
    Returns (model, level) — level is None for fixed-rate models so callers
    can record it in stream metadata (decompress at a different fold level
    would desync the rANS decode into garbage)."""
    if not cfg.model.name.startswith("gained"):
        return model, None
    from neural_image_compression_tpu_torch.models import fold_gains, folded_model

    level = float(getattr(args, "level", None) or 0.0)
    n = len(model.levels)
    if not (0 <= level <= n - 1):
        sys.exit(f"--level must be in [0, {n - 1}] for this model's "
                 f"{n}-point ladder (fractional = interpolated rate)")
    print(f"gained model: folded at level {level} "
          f"(lambda ladder {list(model.levels)})")
    folded = folded_model(model)
    folded.load_state_dict(fold_gains(model.state_dict(), level))
    return folded, level


def cmd_preprocess(args):
    from neural_image_compression_tpu_torch.data.preprocess import preprocess_images

    n = preprocess_images(args.input_dir, args.output_dir, args.target_size,
                          args.min_factor, args.saturation_thresh, args.seed,
                          args.overwrite)
    print(f"Preprocessed {n} images -> {args.output_dir}")


def cmd_download_coco(args):
    from neural_image_compression_tpu_torch.data.coco import download_coco_subset

    download_coco_subset(out_dir=args.out_dir, split=args.split,
                         n_images=args.n_images)


def _data_parallel_mesh():
    """The mesh over every rank: torchrun's process group, else a group of
    this one process (the JAX package's mesh over the host's devices)."""
    import socket

    from torch import distributed as dist

    from neural_image_compression_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed()
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        init_distributed(f"localhost:{port}", 1, 0)
    return make_mesh()


def cmd_train(args):
    cfg = _load_config(args.config)
    if args.train_dir:
        cfg.data.train_dir = args.train_dir
    if args.val_dir:
        cfg.data.val_dir = args.val_dir
    if args.max_steps:
        cfg.train.max_steps = args.max_steps
    if getattr(args, "backbone", None):
        cfg.train.backbone = args.backbone
    if getattr(args, "loss", None):
        cfg.train.loss = args.loss
    if cfg.train.loss not in ("mse", "msssim"):
        raise SystemExit(f"unknown train loss {cfg.train.loss!r} "
                         "(expected 'mse' or 'msssim')")
    if cfg.train.loss == "msssim" and cfg.model.name == "scalable":
        raise SystemExit("loss='msssim' is not supported for the scalable "
                         "model (it trains with vision_rd_loss)")

    from neural_image_compression_tpu_torch.data import BatchLoader, ImageFolderDataset
    from neural_image_compression_tpu_torch.train import (
        Trainer, msssim_rd_loss, rd_loss, vision_rd_loss,
    )

    model = _build(cfg, args)
    train_loader = BatchLoader(ImageFolderDataset(cfg.data.train_dir),
                               batch_size=cfg.data.batch_size,
                               shuffle=cfg.data.shuffle, seed=cfg.data.seed)
    val_loader = (BatchLoader(ImageFolderDataset(cfg.data.val_dir), batch_size=1)
                  if cfg.data.val_dir else None)

    mesh = _data_parallel_mesh() if cfg.train.data_parallel else None

    loss_fn = msssim_rd_loss if cfg.train.loss == "msssim" else rd_loss
    if cfg.model.name == "scalable":
        import functools

        frozen_activation, V = _distillation_callables(cfg, model)
        loss_fn = functools.partial(vision_rd_loss, gamma=cfg.train.gamma,
                                    frozen_activation=frozen_activation, V=V)

    trainer = Trainer(model, train_loader, val_loader=val_loader, rd_loss=loss_fn,
                      lambda_val=cfg.train.lambda_rd,
                      learning_rate=cfg.train.learning_rate,
                      scheduler=cfg.train.scheduler, max_steps=cfg.train.max_steps,
                      resume=cfg.train.resume, log_interval=cfg.train.log_interval,
                      img_interval=cfg.train.img_interval,
                      val_interval=cfg.train.val_interval,
                      checkpoint_interval=cfg.train.checkpoint_interval,
                      scalar_interval=cfg.train.scalar_interval,
                      preemption_safe=cfg.train.preemption_safe,
                      log_dir=cfg.train.log_dir,
                      checkpoint_path=cfg.train.checkpoint_path,
                      seed=cfg.train.seed, mesh=mesh,
                      ema_decay=cfg.train.ema_decay or None,
                      clip_grad_norm=cfg.train.clip_grad_norm or None)
    trainer.train()


def _distillation_callables(cfg, model, require_gamma: bool = True):
    """(frozen_activation, V) for the scalable vision term, or (None, None),
    on the model's device.

    Distillation teacher: FirstHalf of the saved frozen backbone; activation
    = the cut layer's frozen BN + SiLU (Extra.py semantics). Training skips
    the construction when gamma == 0 (the term would cost a full backbone
    forward per step, weighted by zero); eval reports vision_mse whenever a
    backbone is given, gamma or not (pass require_gamma=False)."""
    if not cfg.train.backbone or (require_gamma and cfg.train.gamma <= 0):
        return None, None
    from neural_image_compression_tpu_torch.models.backbones import (
        distillation_targets, load_backbone,
    )

    backbone = load_backbone(cfg.train.backbone, device=next(model.parameters()).device)
    return distillation_targets(backbone, cfg.train.backbone_cut)


def cmd_eval(args):
    cfg = _load_config(args.config)
    if args.data_dir:
        cfg.eval.data_dir = args.data_dir

    from neural_image_compression_tpu_torch.data import BatchLoader, KodakDataset
    from neural_image_compression_tpu_torch.evaluation import (
        CompressionEvaluator, VisionCompressionEvaluator,
    )

    model = _build(cfg, args)
    loader = BatchLoader(KodakDataset(cfg.eval.data_dir), batch_size=1)
    _restore_params(model, cfg)
    model, level = _materialize_level(cfg, model, args)

    if cfg.model.name == "scalable":
        import functools

        from neural_image_compression_tpu_torch.train import vision_rd_loss

        if getattr(args, "backbone", None):
            cfg.train.backbone = args.backbone
        ev = VisionCompressionEvaluator(model, loader, cfg.eval.lambda_rd,
                                        cfg.train.gamma, cfg.eval.save_dir)
        frozen_activation, V = _distillation_callables(cfg, model, require_gamma=False)
        metrics, imgs, recons = ev.evaluate(functools.partial(
            vision_rd_loss, frozen_activation=frozen_activation, V=V))
    else:
        ev = CompressionEvaluator(model, loader, cfg.eval.lambda_rd, cfg.eval.save_dir)
        metrics, imgs, recons = ev.evaluate()
    if getattr(args, "codec", False):
        codec_metrics = ev.evaluate_codec(_make_codec(cfg, model))
        metrics.update({f"codec/{k}": v for k, v in codec_metrics.items()
                        if k.startswith("BPP")})
    ev.save_results(metrics, cfg.eval.nb_steps, cfg.eval.caption)


def _make_codec(cfg: Config, model, card_path=None):
    from neural_image_compression_tpu_torch.coding import (
        ChannelCheckerboardCodec, CheckerboardCodec, FactorizedPriorCodec,
        JointARCodec, MeanScaleHyperpriorCodec, ScalableCodec,
    )

    cls = {"factorized": FactorizedPriorCodec,
           "scalable": ScalableCodec,
           "hyperprior": MeanScaleHyperpriorCodec,
           "gained_hyperprior": MeanScaleHyperpriorCodec,
           "checkerboard": CheckerboardCodec,
           "gained_checkerboard": CheckerboardCodec,
           "channel_cb": ChannelCheckerboardCodec,
           "elic": ChannelCheckerboardCodec,
           "gained_channel_cb": ChannelCheckerboardCodec,
           }.get(cfg.model.name, JointARCodec)
    if card_path and os.path.exists(card_path):
        from neural_image_compression_tpu_torch.coding import portable as P

        if cls is ChannelCheckerboardCodec:
            return cls(model, portable_card=P.ChannelCBCards.load(card_path))
        if cls is FactorizedPriorCodec:
            return cls(model, portable_card=P.FactorizedCard.load(card_path))
        if cls is ScalableCodec:
            return cls(model, portable_cards=P.load_scalable_cards(card_path))
        return cls(model, portable_card=P.PortableCard.load(card_path))
    return cls(model)


def _auto_streams(args, cfg) -> int:
    """--streams default: one interleaved rANS stream per core (rate cost
    ~4*(N-1) bytes/image, decode parallelism for free); 1 on 1-core hosts
    and for the non-AR codecs."""
    n = getattr(args, "streams", None)
    if n is not None:
        return n
    if cfg.model.name in ("factorized", "scalable"):
        return 1
    return min(16, os.cpu_count() or 1)


def _write_stream(path, meta, data):
    with open(path, "wb") as f:
        f.write(len(json.dumps(meta)).to_bytes(2, "little"))
        f.write(json.dumps(meta).encode())
        f.write(data)


def _refined_streams(cfg, model, args, imgs, encode):
    """--refine: each image's latents after args.refine Adam steps against
    the rate-distortion objective, coded by encode(y_q, z_q, h, w) (z_q None
    for the factorized prior)."""
    import numpy as np

    from neural_image_compression_tpu_torch.coding.refine import make_refiner
    from neural_image_compression_tpu_torch.data import pad_to_multiple

    mult = 16 if cfg.model.name == "factorized" else 64
    lam = (args.refine_lambda if args.refine_lambda is not None
           else cfg.train.lambda_rd)
    refiner = make_refiner(model, lam, steps=args.refine, lr=args.refine_lr)
    streams = []
    for src, p in zip(args.image, imgs):
        h0, w0 = p.shape[1], p.shape[2]
        xp = pad_to_multiple(p.astype(np.float32) / 255.0, mult)
        y_q, z_q, m = refiner(xp)
        y_q = y_q.cpu().numpy()[0]
        z_q = None if cfg.model.name == "factorized" else z_q.cpu().numpy()[0]
        streams.append(encode(y_q, z_q, h0, w0))
        print(f"{os.path.basename(src)}: refined {args.refine} "
              f"steps, RD loss {float(m['pre_loss']):.4f} -> "
              f"{float(m['post_loss']):.4f} (lambda {lam})")
    return streams


def cmd_compress(args):
    import numpy as np

    cfg = _load_config(args.config)
    from neural_image_compression_tpu_torch.data import load_image, pad_to_multiple

    model = _build(cfg, args)
    # uint8 straight from the decoder: the codecs divide by 255 on the
    # device, which uploads 4x less than host-side f32 and yields the
    # identical stream
    imgs = [load_image(p, np.uint8)[None] for p in args.image]
    sizes = [im.shape[1:3] for im in imgs]
    _restore_params(model, cfg)
    if getattr(args, "target_bpp", None) is not None:
        if not cfg.model.name.startswith("gained"):
            sys.exit("--target_bpp requires a variable-rate model (config "
                     "model.name='gained'/'gained_hyperprior'/"
                     "'gained_checkerboard')")
        if getattr(args, "level", None) is not None:
            sys.exit("--target_bpp and --level are mutually exclusive "
                     "(the target search picks the level)")
        from neural_image_compression_tpu_torch.models import level_for_bpp

        # search on the first image; the chosen level folds once and is
        # recorded in every stream's metadata (like an explicit --level)
        example = pad_to_multiple(imgs[0].astype(np.float32) / 255.0, 64)
        with torch.no_grad():
            lvl, got = level_for_bpp(model, example, args.target_bpp)
        print(f"target {args.target_bpp:.4f} bpp -> level {lvl:.4f} "
              f"(analytic {got:.4f} bpp on {os.path.basename(args.image[0])})")
        args.level = lvl
    model, level = _materialize_level(cfg, model, args)
    card_path = getattr(args, "card", None)
    portable = getattr(args, "portable", False) or bool(card_path)
    codec = _make_codec(cfg, model, card_path if portable else None)

    multi = len(imgs) > 1
    outs = ([os.path.join(args.out, os.path.splitext(
                os.path.basename(p))[0] + ".nic") for p in args.image]
            if multi else [args.out])
    if len(set(outs)) != len(outs):
        sys.exit("input basenames collide — outputs would overwrite each "
                 "other; rename the inputs or compress them separately")
    if multi:
        os.makedirs(args.out, exist_ok=True)
    factorized = cfg.model.name == "factorized"
    if portable:
        if getattr(args, "streams", None) not in (None, 1):
            sys.exit("--streams does not apply to portable streams (they "
                     "decode serially by spec); drop one of the flags")
        if getattr(args, "refine", None):
            if not hasattr(codec, "compress_latents_portable"):
                sys.exit(f"--refine is not supported for the "
                         f"{cfg.model.name} family's portable streams")
            streams = _refined_streams(
                cfg, model, args, imgs,
                lambda y, z, h, w: (codec.compress_latents_portable(y, h, w) if factorized
                                    else codec.compress_latents_portable(y, z, h, w)))
        else:
            streams = [codec.compress_portable(p) for p in imgs]
        if card_path and not os.path.exists(card_path):
            if cfg.model.name == "scalable":
                from neural_image_compression_tpu_torch.coding.portable import (
                    save_scalable_cards,
                )

                save_scalable_cards(card_path, codec.portable_cards())
            else:
                codec.portable_card().save(card_path)
            print(f"portable card saved -> {card_path}")
    else:
        n_streams = _auto_streams(args, cfg)
        if n_streams > 1 and cfg.model.name in ("factorized", "scalable"):
            sys.exit("--streams applies to the joint-AR and checkerboard "
                     "models only (the factorized codec is already fully "
                     "parallel; the scalable codec's layers decode "
                     "concurrently)")
        same_shape = len({p.shape for p in imgs}) == 1
        kw = {"n_streams": n_streams} if n_streams > 1 else {}
        if getattr(args, "refine", None):
            if not hasattr(codec, "compress_latents"):
                sys.exit(f"--refine is not supported for the "
                         f"{cfg.model.name} family (no compress_latents)")
            streams = _refined_streams(
                cfg, model, args, imgs,
                lambda y, z, h, w: (codec.compress_latents(y, h, w) if factorized
                                    else codec.compress_latents(y, z, h, w, **kw)))
        # Multi-image jobs prefer the batched path (one device pass +
        # threaded host AR) unless the user EXPLICITLY asked for interleaved
        # streams; the auto-streams default must not silently disable it.
        elif (multi and same_shape and getattr(args, "streams", None) is None
                and hasattr(codec, "compress_batch")):
            streams = codec.compress_batch(np.concatenate(imgs))
        else:
            streams = [codec.compress(p, **kw) for p in imgs]
    for src, out, (h, w), data in zip(args.image, outs, sizes, streams):
        meta = {"orig_h": h, "orig_w": w}
        if level is not None:
            # decompressing a gained stream at a different fold level derives
            # wrong entropy params and desyncs the rANS decode — record the
            # level so cmd_decompress can use/validate it
            meta["level"] = level
        _write_stream(out, meta, data)
        print(f"{src} -> {out}: {len(data)} bytes, "
              f"{len(data) * 8 / (h * w):.4f} bpp")


def cmd_decompress(args):
    from PIL import Image

    cfg = _load_config(args.config)
    metas, datas = [], []
    for path in args.bitstream:
        with open(path, "rb") as f:
            mlen = int.from_bytes(f.read(2), "little")
            metas.append(json.loads(f.read(mlen).decode()))
            datas.append(f.read())

    model = _build(cfg, args)
    if cfg.model.name.startswith("gained"):
        # streams written by cmd_compress record the fold level; decoding at
        # any other level desyncs the rANS decode into garbage, so the
        # recorded level wins and a contradicting --level is a hard error
        recorded = {m["level"] for m in metas if "level" in m}
        if len(recorded) > 1:
            sys.exit(f"bitstreams were compressed at different fold levels "
                     f"{sorted(recorded)}; decode them separately")
        if recorded:
            rec = recorded.pop()
            if args.level is not None and float(args.level) != float(rec):
                sys.exit(f"--level {args.level} contradicts the level "
                         f"recorded in the bitstream ({rec}); drop --level "
                         f"or pass --level {rec}")
            args.level = rec
        elif args.level is None:
            print("WARNING: gained streams lack a recorded fold level "
                  "(written by an older version); assuming level 0.0 — "
                  "pass --level if they were compressed at another level")
    _restore_params(model, cfg)
    model, level = _materialize_level(cfg, model, args)
    card_path = getattr(args, "card", None)
    if card_path and not os.path.exists(card_path):
        # compress builds a missing card; decode against a card other than
        # the one the user named must never happen silently
        sys.exit(f"portable card not found: {card_path}")
    codec = _make_codec(cfg, model, card_path)

    multi = len(datas) > 1
    outs = ([os.path.join(args.out, os.path.splitext(
                os.path.basename(p))[0] + ".png") for p in args.bitstream]
            if multi else [args.out])
    if len(set(outs)) != len(outs):
        sys.exit("bitstream basenames collide — outputs would overwrite "
                 "each other; rename the inputs or decode them separately")
    if multi:
        os.makedirs(args.out, exist_ok=True)
    same_shape = len({(m["orig_h"], m["orig_w"]) for m in metas}) == 1
    # kind byte: 4/5/6/8/10/12 = joint/factorized/scalable/checkerboard/
    # hyperprior/channel_cb portable (the codecs' _KIND_*)
    portable = any(len(d) > 4 and d[4] in (4, 5, 6, 8, 10, 12) for d in datas)
    # as_uint8: clip/round/*255 runs on the device and uint8 pixels come
    # off it (4x less download traffic than f32 reconstructions)
    if multi and same_shape and not portable \
            and hasattr(codec, "decompress_batch"):
        recons = list(codec.decompress_batch(datas, as_uint8=True))
    else:
        recons = [codec.decompress(d, as_uint8=True)[0] for d in datas]
    for path, out, meta, x_hat in zip(args.bitstream, outs, metas, recons):
        Image.fromarray(x_hat[:meta["orig_h"], :meta["orig_w"]]).save(out)
        print(f"{path} -> {out}")


def cmd_export(args):
    from neural_image_compression_tpu_torch import serving

    if args.height % 64 or args.width % 64:
        sys.exit(f"H and W must be multiples of 64 (the model's total "
                 f"downsampling), got {args.height}x{args.width}")
    cfg = _load_config(args.config)
    model = _build(cfg, args)
    _restore_params(model, cfg)
    model, level = _materialize_level(cfg, model, args)
    try:
        exported = serving.export_model(model, args.height, args.width, batch=args.batch)
    except ValueError as e:
        sys.exit(str(e))
    serving.save_exported(exported, args.out)
    size_mb = os.path.getsize(args.out) / 1e6
    b = args.batch if args.batch is not None else "b (symbolic)"
    print(f"exported {cfg.model.name} eval forward "
          f"[{b}, {args.height}, {args.width}, 3] -> {args.out} "
          f"({size_mb:.1f} MB, device={next(model.parameters()).device})")


def cmd_bdrate(args):
    from neural_image_compression_tpu_torch.evaluation import bd_psnr, bd_rate

    def load(path):
        with open(path) as f:
            pts = json.load(f)
        if not isinstance(pts, list):
            sys.exit(f"{path}: expected a JSON list of RD points "
                     "(the rd_curve.json written by lambda_sweep)")
        return pts

    anchor, test = load(args.anchor), load(args.test)
    try:
        out = {"bd_rate_pct": round(bd_rate(anchor, test, args.metric), 4),
               "bd_" + args.metric: round(bd_psnr(anchor, test, args.metric), 4),
               "metric": args.metric}
    except ValueError as e:
        sys.exit(f"BD computation failed: {e}")
    print(json.dumps(out))


def cmd_anchor_curve(args):
    import numpy as np

    from neural_image_compression_tpu_torch.data import ImageFolderDataset
    from neural_image_compression_tpu_torch.evaluation.anchors import classical_rd_curve

    ds = ImageFolderDataset(args.data_dir)
    if len(ds) == 0:
        sys.exit(f"{args.data_dir}: no images found")
    images = [np.asarray(ds[i]) for i in range(len(ds))]
    qualities = ([int(q) for q in args.qualities.split(",")]
                 if args.qualities else None)
    try:
        curve = classical_rd_curve(images, args.codec, qualities,
                                   with_msssim=args.msssim,
                                   device=_device(args) if args.msssim else None)
    except ValueError as e:
        sys.exit(str(e))
    with open(args.out, "w") as f:
        json.dump(curve, f, indent=1)
    for p in curve:
        extra = f" msssim={p['msssim']:.4f}" if "msssim" in p else ""
        print(f"{args.codec} q={p['quality']:3d}: bpp={p['bpp']:.4f} "
              f"psnr={p['psnr']:.2f}{extra}")
    print(f"-> {args.out} ({len(images)} images); compare with: "
          f"bdrate {args.out} <model rd_curve.json>")


def _add_device(sp, what="the model"):
    sp.add_argument("--device", default="cuda",
                    help=f"device {what} runs on (default cuda; cpu runs the "
                         "kernels' plain versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="neural_image_compression_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("preprocess")
    sp.add_argument("--input_dir", required=True)
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--target_size", type=int, default=256)
    sp.add_argument("--min_factor", type=float, default=0.75)
    sp.add_argument("--saturation_thresh", type=float, default=0.95)
    sp.add_argument("--seed", type=int, default=None)
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("download-coco")
    sp.add_argument("--out_dir", default="./data/coco_train_subset")
    sp.add_argument("--split", default="train2017")
    sp.add_argument("--n_images", type=int, default=1000)
    sp.set_defaults(fn=cmd_download_coco)

    sp = sub.add_parser("train")
    sp.add_argument("--config", default=None)
    sp.add_argument("--train_dir", default=None)
    sp.add_argument("--val_dir", default=None)
    sp.add_argument("--max_steps", type=int, default=None)
    sp.add_argument("--loss", default=None, choices=("mse", "msssim"),
                    help="training distortion: 'mse' (reference objective) or "
                         "'msssim' (bpp + lambda*(1-MS-SSIM))")
    sp.add_argument("--backbone", default=None,
                    help="saved backbone .npz for scalable vision "
                         "distillation (models.save_backbone)")
    _add_device(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval")
    sp.add_argument("--config", default=None)
    sp.add_argument("--data_dir", default=None)
    sp.add_argument("--codec", action="store_true",
                    help="also run real-bitstream codec evaluation")
    sp.add_argument("--backbone", default=None,
                    help="saved backbone .npz: report the vision-distillation "
                         "MSE for scalable models")
    sp.add_argument("--level", type=float, default=None,
                    help="gained models: rate level to fold at "
                         "(0..N-1, fractional = interpolated)")
    _add_device(sp)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("compress")
    sp.add_argument("--config", default=None)
    sp.add_argument("--image", required=True, nargs="+",
                    help="one or more images; several same-size images "
                         "encode as one batched device pass + threaded host AR")
    sp.add_argument("--out", required=True,
                    help="output file (single image) or directory (several)")
    sp.add_argument("--streams", type=int, default=None,
                    help="N-way interleaved rANS (rate-neutral multicore "
                         "decode; joint-AR models only). Default: one "
                         "stream per core")
    sp.add_argument("--portable", action="store_true",
                    help="cross-machine deterministic streams (integer "
                         "codec path; joint-AR, checkerboard, channel_cb, "
                         "hyperprior, factorized and scalable models)")
    sp.add_argument("--refine", type=int, default=None, metavar="STEPS",
                    help="encode-time latent refinement: STEPS Adam steps "
                         "on the latents against the true R+lambda*D "
                         "objective before coding (coding/refine.py); "
                         "decode is unchanged")
    sp.add_argument("--refine_lr", type=float, default=1e-3,
                    help="refinement learning rate (default 1e-3; larger "
                         "rates can diverge on converged models)")
    sp.add_argument("--refine_lambda", type=float, default=None,
                    help="refinement rate-distortion lambda (default: the "
                         "config's train.lambda_rd)")
    sp.add_argument("--card", default=None,
                    help="portable-card file: loaded if it exists, else "
                         "built from the model and saved here (implies "
                         "--portable)")
    sp.add_argument("--level", type=float, default=None,
                    help="gained models: rate level to fold at "
                         "(0..N-1, fractional = interpolated)")
    sp.add_argument("--target_bpp", type=float, default=None,
                    help="gained models: bisect the gain ladder for the "
                         "level matching this analytic bpp on the first "
                         "image, then compress at that level (mutually "
                         "exclusive with --level)")
    _add_device(sp)
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress")
    sp.add_argument("--config", default=None)
    sp.add_argument("--bitstream", required=True, nargs="+")
    sp.add_argument("--out", required=True,
                    help="output file (single stream) or directory (several)")
    sp.add_argument("--card", default=None,
                    help="portable-card file for portable bitstreams")
    sp.add_argument("--level", type=float, default=None,
                    help="gained models: rate level to fold at "
                         "(0..N-1, fractional = interpolated)")
    _add_device(sp)
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("export",
                        help="freeze the eval forward (weights in its state "
                             "dict) into a torch.export serving artifact")
    sp.add_argument("--config", default=None)
    sp.add_argument("--out", required=True)
    sp.add_argument("--height", type=int, default=512)
    sp.add_argument("--width", type=int, default=768)
    sp.add_argument("--batch", type=int, default=None,
                    help="fixed batch size; default: symbolic (any B)")
    sp.add_argument("--level", type=float, default=None,
                    help="gained models: rate level to fold at "
                         "(0..N-1, fractional = interpolated)")
    _add_device(sp, "the artifact is exported for and served")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("anchor-curve",
                        help="classical-codec (JPEG/WebP) anchor RD curve "
                             "over an image folder, for BD-rate comparison")
    sp.add_argument("--data_dir", required=True)
    sp.add_argument("--codec", default="jpeg", choices=["jpeg", "webp"])
    sp.add_argument("--qualities", default=None,
                    help="comma-separated quality ladder "
                         "(default: per-codec ladder)")
    sp.add_argument("--msssim", action="store_true",
                    help="also compute MS-SSIM per point (slower)")
    sp.add_argument("--out", default="anchor_curve.json")
    _add_device(sp, "MS-SSIM")
    sp.set_defaults(fn=cmd_anchor_curve)

    sp = sub.add_parser("bdrate",
                        help="Bjøntegaard delta between two RD curves "
                             "(rd_curve.json files from lambda_sweep)")
    sp.add_argument("anchor")
    sp.add_argument("test")
    sp.add_argument("--metric", default="psnr",
                    help="quality key in the RD points (psnr | msssim)")
    sp.set_defaults(fn=cmd_bdrate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
