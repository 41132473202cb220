"""How far the JAX package's Newton optimizers bring the tensor-rank (CP)
decomposition of examples/tensor_rank_decomposition.py down in the first
steps, with the example's settings: the reference fall that the port's
``chip_smoke.py`` tensor-rank path gates on.

    python tools/cp_fall_jax.py [--steps 200 400]

Runs on the CPU (float32, the example's data from key 0) and prints, per
optimizer, the loss at step 0 and after each count of steps, and the
fall (first loss over the loss then).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import optax  # noqa: E402

import psgd_torch_tpu.optim as popt  # noqa: E402
from tensor_rank_decomposition import make_problem  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, nargs="+", default=[200, 400])
    args = ap.parse_args()
    loss_fn, init = make_problem(jax.random.key(0))
    hvp_fn = popt.make_hvp_fn(loss_fn)
    settings = dict(learning_rate=0.2, lr_preconditioner=0.5, momentum=0.9,
                    grad_clip_max_norm=10.0)
    for name, opt in (("dense_newton Q0.5EQ1.5", popt.dense_newton(**settings)),
                      ("lra_newton rank 10", popt.lra_newton(
                          rank_of_approximation=10, **settings))):
        params, state = list(init), opt.init(list(init))

        @jax.jit
        def step(params, state):
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, state = opt.update(grads, state, params, hvp_fn=hvp_fn)
            return optax.apply_updates(params, updates), state, loss

        losses = []
        for _ in range(max(args.steps)):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        falls = ", ".join(f"{k} steps {losses[k - 1]:.6g} ({losses[0] / losses[k - 1]:.3g}x)"
                          for k in args.steps)
        print(f"{name}: step 0 {losses[0]:.6g}; {falls}", flush=True)


if __name__ == "__main__":
    main()
