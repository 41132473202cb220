"""The port's six other Kron geometries (EQ, QEP, QEQ, QUAD, QUAD4P, PRO4P)
in their Newton fits, per tensor and stacked, against the JAX package's
update_kron_newton and update_kron_newton_stacked, in float64 on replayed
draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu_torch.ops import linalg as tlinalg
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import _compare_states, jax_draw
from test_torch_kron_geometries import (FITS, GEOMETRIES, SHAPES, STACKED,
                                        _keys, geometry_state, jax_fit)


def _newton_fits(dq, case, batch):
    """FITS Newton fits on both sides from one random state, each on a fresh
    probe v and stand-in Hvp h and key; yields (port, JAX) per fit."""
    shape, skew = SHAPES[case]
    plan, ts, js, jplan = geometry_state(shape, skew, dq, 51, batch)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(52)
    name = "update_kron_newton" if batch is None else "update_kron_newton_stacked"
    port = getattr(tkron, name)
    ref = jax_fit(name, jplan, lr=0.2, norm_k=8)
    for t in range(FITS):
        v, h = rng.standard_normal(lead + shape), rng.standard_normal(lead + shape)
        key = _keys(t, batch)
        ts = port(ts, plan, torch.from_numpy(v), torch.from_numpy(h), key,
                  lr=0.2, norm_k=8, draw=jax_draw)
        js = ref(js, v=jnp.asarray(v), h=jnp.asarray(h),
                 **{"key" if batch is None else "keys": jnp.asarray(key)})
        yield ts, js


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("dq", GEOMETRIES)
def test_newton_fit_matches_jax(dq, case):
    """Three Newton fits of one tensor on replayed draws, f64: Q and L
    within rtol 1e-9 of the JAX package's after each fit."""
    for out, ref in _newton_fits(dq, case, None):
        _compare_states(out, ref, 1e-9)


@pytest.mark.parametrize("case", STACKED)
@pytest.mark.parametrize("dq", GEOMETRIES)
def test_newton_fit_stacked_matches_jax(dq, case):
    """Three Newton fits of a layer stack (B = 3) in one call each against
    the JAX stacked update (its vmap of the per-tensor update), f64 on
    replayed draws, rtol 1e-9."""
    for out, ref in _newton_fits(dq, case, 3):
        _compare_states(out, ref, 1e-9)


def test_newton_pro4p_loop_takes_several_steps():
    """The Newton PRO4P fit's Procrustes loop runs on these states (more
    than one step over the first fit's dense factors)."""
    tlinalg.procrustes_loop3.layer_steps = 0
    next(_newton_fits("PRO4P", "order3", 3))
    assert int(tlinalg.procrustes_loop3.layer_steps) > 3
