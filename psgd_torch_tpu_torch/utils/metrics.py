"""Optimizer-health metrics and state memory for the port's optimizers
(counterpart of psgd_torch_tpu/utils/metrics.py; the reference's only
diagnostics are stdout advisories, SURVEY.md §5).

``psgd_metrics(optimizer, updates)`` returns {name: 0-dim device tensor}
with the JAX function's keys; nothing in it syncs the host, so a caller
reads the values (``float(v)``) only where it logs them:

    opt.step()
    metrics = psgd_metrics(opt, updates)
    log({k: float(v) for k, v in metrics.items()})
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _core(optimizer):
    """The port optimizer behind a closure class, or the optimizer."""
    return getattr(optimizer, "optimizer", optimizer)


def _preconditioners(opt):
    """(name, factors, lips, rows) per preconditioner, in the JAX state's
    order: Kron one per parameter ("leaf{i}", its Q factors and L's);
    Affine one per parameter ("leaf{i}", its two sides, no L); dense one
    ("leaf", Q, L); LRA and the other legacy families one ("leaf", every
    field, no L), as the JAX module summarises a state without ``.q``.
    ``rows``: whether the factors' row maxima count for
    ``q_rowmax_min``."""
    precond = getattr(opt, "precond", None)
    if precond is None:
        for i, p in enumerate(opt.param_groups[0]["params"]):
            st = opt.state[p]
            if "q" in st:
                yield f"leaf{i}", st["q"], st["lips"], True
            else:
                yield f"leaf{i}", (st["ql"], st["qr"]), (), False
    elif hasattr(precond, "lips"):
        yield "leaf", (precond.q,), (precond.lips,), True
    else:
        yield "leaf", tuple(precond), (), False


def _momentum(opt) -> list:
    if getattr(opt, "precond", None) is not None:
        return [] if opt.mu is None else [opt.mu]
    return [st[k] for st in (opt.state[p] for p in opt.param_groups[0]["params"])
            for k in ("mu", "momentum") if k in st]


def _rms(xs) -> torch.Tensor:
    """RMS in float32; of a complex tensor the real part, as JAX's
    ``x.astype(jnp.float32)`` reads it."""
    sq = sum(torch.sum(torch.square(torch.real(x).to(torch.float32))) for x in xs)
    return torch.sqrt(sq / sum(x.numel() for x in xs))


def psgd_metrics(optimizer, updates: Optional[list] = None,
                 per_leaf: bool = False) -> Dict[str, torch.Tensor]:
    """Scalar health metrics of a port optimizer (or closure class), as
    JAX's ``psgd_metrics`` computes them from its state: ``step``;
    ``L_max``, the largest Lipschitz estimate (its growth exposes a
    diverging fit); ``q_abs_max`` and ``q_rowmax_min``, the extremes of
    |Q| (the over- and underflow watch behind the balancing); and
    ``momentum_rms``.  With ``updates`` (tensors: what the step moved the
    parameters by) ``update_rms`` and ``update_abs_max``, the amplitude
    clip's engagement signal; with ``per_leaf`` ``L_max/leaf{i}`` and
    ``q_abs_max/leaf{i}``.  Reductions in float32; values are 0-dim tensors
    on the optimizer's device.  An optimizer whose state is its rank's own
    (``stack_sharding``, ``factor_sharding``, the per-shard optimizers)
    reports that state, and
    every key but ``step`` and the update's says so: ``L_max@rank{r}``."""
    opt = _core(optimizer)
    out: Dict[str, torch.Tensor] = {
        "step": torch.full((), opt.count, dtype=torch.int32,
                           device=opt.device)}
    lips_all, qmax_all, qmin_all = [], [], []
    for name, factors, lips, rows in _preconditioners(opt):
        mags = [torch.abs(f).to(torch.float32) for f in factors]
        if lips:
            lips_all.append(torch.stack(
                [torch.amax(torch.real(x).to(torch.float32)) for x in lips]).amax())
            if per_leaf:
                out[f"L_max/{name}"] = lips_all[-1]
        if mags:
            qmax_all.append(torch.stack([torch.amax(a) for a in mags]).amax())
            if per_leaf:
                out[f"q_abs_max/{name}"] = qmax_all[-1]
        if rows and mags:
            qmin_all.append(torch.stack(
                [torch.amin(torch.amax(a.reshape(-1, a.shape[-1] if a.ndim
                                                 else 1), -1))
                 for a in mags]).amin())
    for key, vals in (("L_max", lips_all), ("q_abs_max", qmax_all)):
        if vals:
            out[key] = torch.stack(vals).amax()
    if qmin_all:
        out["q_rowmax_min"] = torch.stack(qmin_all).amin()
    mus = _momentum(opt)
    if mus:
        out["momentum_rms"] = _rms(mus)
    if getattr(opt, "per_rank", False):
        import torch.distributed as dist
        at = f"@rank{dist.get_rank()}"
        out = {k if k == "step" else k + at: v for k, v in out.items()}
    if updates is not None:
        updates = list(updates)
        out["update_rms"] = _rms(updates)
        out["update_abs_max"] = torch.stack(
            [torch.amax(torch.abs(x).to(torch.float32)) for x in updates]).amax()
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def state_memory_report(optimizer, per_device: bool = False) -> Dict[str, int]:
    """Bytes of a port optimizer's state by role, as JAX's
    ``state_memory_report``: ``q`` (Kron and dense Q; LRA's U, V and d),
    ``lips`` (the Lipschitz estimates), ``momentum``, ``pcache`` (the
    ``cache_p`` factors P_i), ``other`` and ``total``.  ``other`` is 0:
    the port keeps count, key and fit_steps on the host, where JAX holds
    its count (int32) and key (uint32[2]) as 12 bytes of device arrays.
    With ``stack_sharding``, ``factor_sharding`` or ``vector_sharding``
    ``per_device`` gives this rank's bytes, else the whole state over the
    mesh (each sharded stack's slice times the shard count; a routed
    leaf's momentum and diagonal factors, its blocks times theirs, its
    dense factors and L once; LRA's rows of U, V, d and the momentum, and
    dense's rows of Q, times the ranks, padded n included); a per-shard
    optimizer reports its rank's own either way."""
    opt = _core(optimizer)
    report = {"q": 0, "lips": 0, "momentum": _nbytes(_momentum(opt)),
              "pcache": 0, "other": 0}
    precond = getattr(opt, "precond", None)
    if precond is None:
        stack = getattr(opt, "stack", None)
        routed = getattr(opt, "routed", None)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            st = opt.state[p]
            k = (stack.size if stack is not None and opt.sharded[i]
                 and not per_device else 1)
            r = routed[i] if routed else None
            if r is not None and not per_device:
                eff = r.rplan[0]
                ks = [opt.comm.size(eff[j]) if f.ndim == 1 else 1
                      for j, f in enumerate(st["q"])]
                report["q"] += sum(c * _nbytes((f,)) for c, f in zip(ks, st["q"]))
                report["pcache"] += sum(c * _nbytes((f,)) for c, f in
                                        zip(ks, st.get("pcache", ())))
                report["lips"] += _nbytes(st["lips"])
                if "mu" in st:
                    report["momentum"] += (opt.comm.size(
                        [a for axes in r.dim_axes for a in axes]) - 1) \
                        * _nbytes((st["mu"],))
                continue
            report["q"] += k * _nbytes(st["q"])
            report["lips"] += k * _nbytes(st["lips"])
            report["pcache"] += k * _nbytes(st.get("pcache", ()))
    else:
        # vector_sharding: the rows times the ranks over the group; the
        # momentum too where it is a row block (LRA)
        rows = getattr(opt, "rows", None)
        k = 1 if rows is None or per_device else rows.size
        if hasattr(precond, "lips"):
            report["q"] = k * _nbytes((precond.q,))
            report["lips"] = _nbytes((precond.lips,))
        else:
            report["q"] = k * _nbytes((precond.u, precond.v, precond.d))
            report["lips"] = _nbytes((precond.lu, precond.lv, precond.ld))
        if opt.ROW_VECTORS:
            report["momentum"] *= k
    report["total"] = sum(report.values())
    return report
