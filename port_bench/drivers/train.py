"""Training: steps of the program's train step enqueued ahead
(``traffic.train_window``); the check compares the step's first three
calls, made at set-up through the window's own call, with the reference's
three steps of plain autograd and Adam."""

from typing import Dict

import torch

from port_bench import checks, traffic


def unit_name(config) -> str:
    """The configuration's name for one step ("train", "distill")."""
    return config["step_name"]


def setup(session) -> None:
    from neural_image_compression_tpu_torch.parallel.train_step import make_train_step

    cfg, mix = session.config, session.mix
    session.model.train()
    loss, lam = session.cell.family.build_objective(cfg, session.teacher, session.device)
    session.optimizer = torch.optim.Adam(session.model.parameters(), lr=cfg["learning_rate"],
                                         betas=tuple(cfg["adam_betas"]), eps=cfg["adam_eps"])
    session.step = make_train_step(session.model, session.optimizer, loss, lam)
    session.generator = session.new_generator(session.noise_seed)
    # the checked steps: through the window's own call, on distinct batches
    session.noise_states, losses = [], []
    for k in range(mix["checked_steps"]):
        session.noise_states.append(session.generator.get_state())
        losses.append(session.step(session.pool[k], session.generator)["loss"])
        if k == 0:
            grads = checks.grad_norms_from_adam(session.model, session.optimizer)
    session.program_record = checks.TrainRecord(
        [float(t) for t in losses], grads, checks.change_norms(session.model, session.weights))
    first, warm = mix["checked_steps"], mix["warmup_steps"]
    traffic.train_window(session.step, session.pool, session.generator, float("inf"), first,
                         mix["ahead"], session.clock, session.new_event, session.synchronize,
                         steps=warm)
    session.first = first + warm


def window(session, seconds: float, span) -> traffic.Window:
    return traffic.train_window(session.step, session.pool, session.generator, seconds,
                                session.first, session.mix["ahead"], session.clock,
                                session.new_event, session.synchronize, span=span)


def failed(session, win: traffic.Window) -> int:
    """Steps whose loss is not finite."""
    if not win.outputs:
        return 0
    values = torch.stack([o["loss"].float().reshape(-1).sum() for o in win.outputs])
    return int((~torch.isfinite(values)).sum())


def _reference(session, **kwargs) -> checks.TrainRecord:
    batches = [session.pool[k] for k in range(len(session.noise_states))]
    return checks.reference_train(session.cell, session.weights, session.teacher, batches,
                                  session.noise_states, session.device, **kwargs)


def check(session) -> Dict[str, float]:
    return checks.train_numbers(session.program_record, _reference(session))


def calibration(session) -> dict:
    """The TF32 control's and the half-batch fault's readings beside the
    program's, and the three worst leaves of each leaf-wise number."""
    ref = _reference(session)
    ctl = _reference(session, tf32_on=True)
    half = _reference(session, fault="half_batch")
    prog = session.program_record
    out = {"control_tf32": checks.train_numbers(ctl, ref),
           "fault_half_batch": checks.train_numbers(half, ref),
           "losses": {"program": prog.losses, "reference": ref.losses, "tf32": ctl.losses,
                      "half_batch": half.losses}}
    leaves = checks.counted_leaves(ref)
    out["leaves"] = {"counted": len(leaves), "of": len(ref.grad_norms)}
    for what, got, want in (("grad", prog.grad_norms, ref.grad_norms),
                            ("step", prog.change_norms, ref.change_norms)):
        gaps = checks.leaf_gaps(got, want, leaves)
        worst = sorted(gaps, key=gaps.get)[-3:]
        out["leaves"][what] = {n: [gaps[n], want[n], got[n]] for n in worst}
        out["leaves"][what + "_median_leaf"] = checks._median(list(gaps.values()))
    return out
