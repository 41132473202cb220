"""How the JAX package's LRA, dense and legacy optimizers move a complex
least-squares loss in their first steps: the reference that the port's
``chip_smoke.py`` complex LRA, dense and legacy path gates its losses
against (it gates a fall only where this run falls).

    python tools/complex_fall_jax.py [--steps N] [--json PATH] [--vector]

Runs on the CPU, complex64: each arm of ``chip_smoke.CXL_ARMS`` (its JAX
factory, learning rate and options) on the arm's small problem
(``chip_smoke.CXL_SMALL``: the same seeded data, X and Y, as the smoke's
card-against-CPU check, made by ``chip_smoke._cx_problem`` on the CPU),
W from 0.  The optimizers get what the port's get from torch: the
gradient conj(jax.grad) (torch's ``.grad``) and the Hessian action
conj(jvp(jax.grad)) (torch's double backward; checked here against
V X X^H / batch).  Prints, per arm, the loss after each of the smoke's
``CXL_STEPS`` steps and after ``--steps``, and whether it is finite and
below the first.  ``--vector`` runs instead the vector-sharded complex
arms of the smoke's vector-sharded path (``chip_smoke._vector_kw``: arms
D and E, LRAWhiten and LRANewton over 2 shards; arm F, DenseNewton QEQ
over 3) with the JAX transforms' ``vector_sharding`` over as many CPU
devices, on the same small problems.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# the vector-sharded arms' meshes: 2 and 3 CPU devices
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import psgd_torch_tpu.optim as jopt  # noqa: E402


def problem(kind):
    """The arm's small problem as JAX arrays: (W0 leaves, [(X, Y)])."""
    gen = torch.Generator().manual_seed(41)
    params, loss = cs._cx_problem(*cs.CXL_SMALL[kind], torch.complex64,
                                  torch.device("cpu"), gen)
    data = [(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())) for x, y in loss.data]
    return [jnp.asarray(p.detach().numpy()) for p in params], data


# the smoke's vector-sharded complex arms: CXL_ARMS-shaped, then the shards
VECTOR_ARMS = tuple(
    (label, factory, None, newton, kind, kw.pop("lr"), kw, k)
    for label, factory, newton, kind, kw, k in (
        ("LRAWhiten, 2 shards", "lra_whiten", False, "full",
         {key: v for key, v in cs._vector_kw("cx_whiten", None)[1].items()
          if key != "device"}, 2),
        ("LRANewton, 2 shards", "lra_newton", True, "full",
         {key: v for key, v in cs._vector_kw("cx_newton", None)[1].items()
          if key != "device"}, 2),
        ("DenseNewton QEQ, 3 shards", "dense_newton", True, "dense",
         dict(lr=0.2, dq="QEQ"), 3)))


def losses(arm, steps):
    label, factory, _, newton, kind, lr, kw = arm[:7]
    if len(arm) > 7:
        from psgd_torch_tpu.parallel import make_mesh
        kw = dict(kw, vector_sharding=(make_mesh(arm[7], axis_names=("fsdp",)), "fsdp"))
    ws, data = problem(kind)

    def loss(ws):
        return sum(0.5 * jnp.sum(jnp.real((w @ x - y) * jnp.conj(w @ x - y))) / x.shape[-1]
                   for w, (x, y) in zip(ws, data))

    grad = jax.grad(loss)

    def torch_hvp(p, vs):
        return None, jax.tree_util.tree_map(jnp.conj, jax.jvp(grad, (p,), (vs,))[1])

    # the Hessian action torch computes, V X X^H / batch per leaf
    vs = [jnp.ones_like(w) * (1 + 2j) for w in ws]
    for h, v, (x, _) in zip(torch_hvp(ws, vs)[1], vs, data):
        np.testing.assert_allclose(np.asarray(h), np.asarray(v @ (x @ jnp.conj(x.T))
                                                            / x.shape[-1]),
                                   rtol=1e-4, atol=1e-4 * float(jnp.abs(h).max()))
    params = [(f"w{i}", w) for i, w in enumerate(ws)] if factory == "affine" else ws
    params = dict(params) if factory == "affine" else params
    opt = getattr(jopt, factory)(learning_rate=lr, **kw)

    @jax.jit
    def step(p, st):
        leaves = list(p.values()) if isinstance(p, dict) else p
        value = loss(leaves)
        g = jax.tree_util.tree_map(jnp.conj, jax.grad(
            lambda q: loss(list(q.values()) if isinstance(q, dict) else q))(p))
        extra = {}
        if newton:
            extra["hvp_fn"] = lambda q, v: (None, jax.tree_util.tree_map(
                jnp.conj, jax.jvp(jax.grad(
                    lambda r: loss(list(r.values()) if isinstance(r, dict) else r)),
                    (q,), (v,))[1]))
        upd, st = opt.update(g, st, p, **extra)
        return optax.apply_updates(p, upd), st, value

    state, out = opt.init(params), []
    for _ in range(steps):
        params, state, value = step(params, state)
        out.append(float(value))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--json", default=None, help="write every loss there")
    ap.add_argument("--vector", action="store_true",
                    help="the vector-sharded complex arms instead")
    args = ap.parse_args()
    record = {}
    n = cs.CXL_STEPS
    for arm in VECTOR_ARMS if args.vector else cs.CXL_ARMS:
        ls = losses(arm, max(args.steps, n))
        first = ls[:n]
        finite = all(np.isfinite(first))
        print(f"{arm[0]} ({cs.CXL_SMALL[arm[4]]}, lr {arm[5]}, {arm[6]}): first "
              f"{n} losses {', '.join(f'{x:.6g}' for x in first)}; finite {finite}, "
              f"falls {finite and first[-1] < first[0]}; after {len(ls)} steps "
              f"{ls[-1]:.6g}")
        record[arm[0]] = ls
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f)


if __name__ == "__main__":
    main()
