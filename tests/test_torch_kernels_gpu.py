"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from psgd_torch_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _seeds(b, dev):
    return torch.arange(2 * b, dtype=torch.int32, device=dev).reshape(b, 2) * 7919


def _bits(t):
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("per_batch", [1, 7, 8, 4096 + 4, 97 * 33, 768 * 2304])
def test_noise_kernel_bit_exact(dev, per_batch, b, dtype):
    """Both modes against the plain Philox version, bit for bit: lengths
    that are multiples of 8 take the vector kernel (two counters, 16-byte
    accesses per thread), the others (1, 7, 4100, 97 x 33) the scalar one;
    with B = 3 a scalar length starts its batch elements off the vector
    alignment."""
    seeds = _seeds(b, dev)
    g = torch.randn((b, per_batch), device=dev).to(dtype)
    assert _same_bits(kernels.unit_noise(seeds, (per_batch,), dtype),
                      kernels.unit_noise_plain(seeds, (per_batch,), dtype))
    assert _same_bits(kernels.damped_noise(g, seeds, 1e-9),
                      kernels.damped_noise_plain(g, seeds, 1e-9))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128, torch.float64])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("per_batch", [1, 7, 8, 4096 + 2, 97 * 33, 768 * 2304])
def test_noise_complex_and_f64_bit_exact(dev, per_batch, b, dtype):
    """The complex mode (four seed words per batch element: the real part's
    stream, the imaginary part's) and the float64 instantiation, unit and
    fused, bit for bit against their plain versions (two real plain draws
    for a complex dtype; the float32 draw widened for float64): complex
    lengths that are multiples of 4 take the vector kernel, the others the
    scalar one."""
    seeds = torch.arange(kernels.seed_width(dtype) * b, dtype=torch.int32,
                         device=dev).reshape(b, -1) * 7919 + 3
    g = torch.randn((b, per_batch), device=dev, dtype=dtype)
    assert _same_bits(kernels.unit_noise(seeds, (per_batch,), dtype),
                      kernels.unit_noise_plain(seeds, (per_batch,), dtype))
    assert _same_bits(kernels.damped_noise(g, seeds, 1e-9),
                      kernels.damped_noise_plain(g, seeds, 1e-9))


def test_philox_start_is_uniform_pm1(dev):
    """philox_start, the XLA tail's subspace starts: one noise launch at
    scale 2, uniform_pm1's bits, from int32 and from int64 (tagged) seed
    words."""
    from psgd_torch_tpu_torch.ops import philox
    seeds = _seeds(3, dev)
    for s in (seeds, kernels._tagged(seeds)):
        assert torch.equal(kernels.philox_start(s, (32, 768)),
                           philox.uniform_pm1(s, (32, 768)))


def test_xla_route_on_the_card(dev):
    """The XLA tail on CUDA tensors (complex64, (3, 256)): counted in
    xla_ns_update.launches and philox_start.launches (two starts), no NS
    kernel launched, within 1e-4 of the same call on the CPU."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((3, 256, 512), generator=gen, device=dev, dtype=torch.complex64)
    term1 = x @ x.mH / 512
    q = torch.eye(256, device=dev, dtype=torch.complex64) + 0.02 * torch.randn(
        (3, 256, 256), generator=gen, device=dev, dtype=torch.complex64)
    args = (term1, q, torch.zeros(3, device=dev), torch.full((3,), 2.0, device=dev),
            _seeds(3, dev), 0.1, 0.9)
    kernels.reset_launch_counts()
    out, lip = kernels.fused_ns_update(*args)
    assert (kernels.xla_ns_update.launches, kernels.philox_start.launches,
            kernels.fused_ns_update.launches) == (1, 2, 0)
    ref, rlip = kernels.fused_ns_update(*(a.cpu() if torch.is_tensor(a) else a
                                          for a in args))
    assert ((out.cpu() - ref).abs().max() / ref.abs().max()).item() < 1e-4
    assert ((lip.cpu() - rlip).abs() / rlip).max().item() < 1e-4


def test_noise_unaligned_g_takes_the_scalar_kernel(dev):
    """g one element past a 16-byte boundary (a contiguous view) cannot be
    read as vectors: the scalar kernel runs, with the same bits."""
    seeds = _seeds(3, dev)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(3 * 4096 + 1, device=dev).to(dtype)[1:].view(3, 4096)
        assert g.data_ptr() % 16 != 0
        assert _same_bits(kernels.damped_noise(g, seeds, 1e-3),
                          kernels.damped_noise_plain(g, seeds, 1e-3))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 7, 63, 64, 200, 2048])
@pytest.mark.parametrize("dtypes", kernels.TRANSPOSE_SUB_DTYPES + ((torch.float32, "copy"),),
                         ids=["f32", "bf16-f32+r16", "bf16", "f32+r16"])
def test_transpose_sub_bit_exact(dev, dtypes, n, b):
    """Every instantiation of the transpose-subtract against
    ``transpose_sub_plain``, R and R16 bit for bit (signed zeros included):
    f32 -> f32 (tsub and the f32 chains), bf16 -> f32 + R16 (the split
    procrustes), bf16 -> bf16 (tsub), f32 -> f32 + R16 (the bf16 single
    route's f32 q1).  n = 63 and 200 leave ragged tile pairs, n = 1, 7, 63
    take the scalar accesses, the rest 16-byte vectors; tsub gives the bits
    of its instantiation."""
    in_dtype, out_dtype = dtypes
    copy16 = out_dtype == "copy" or in_dtype != out_dtype
    out_dtype = torch.float32 if out_dtype == "copy" else out_dtype
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((b, n, n), generator=gen, device=dev).to(in_dtype)
    h = n // 2
    x[:, :h, :h] = x[:, :h, :h].mT.clone()    # a symmetric block: zeros in R
    r, r16 = kernels.transpose_sub(x, out_dtype, copy16)
    rp, r16p = kernels.transpose_sub_plain(x, out_dtype, copy16)
    assert _same_bits(r, rp)
    assert (r16 is None and r16p is None) or _same_bits(r16, r16p)
    if out_dtype == in_dtype and not copy16:
        assert _same_bits(kernels.tsub(x), rp)


def test_transpose_sub_refuses_other_dtypes(dev):
    x = torch.zeros((1, 8, 8), device=dev)
    with pytest.raises(TypeError):
        kernels.transpose_sub(x, torch.bfloat16)


def _ns_inputs(b, n, dev, dtype):
    """Q's noise is 0.02 on even batch entries and 1e-3 on odd ones, so the
    procrustes step takes both branches: clamped at 1/8, and the trace
    ratio (about the norm of Q's skew part)."""
    gen = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn((b, n, n), generator=gen, device=dev)
    term1 = (a @ a.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev))
    noise = torch.tensor([0.02, 1e-3], device=dev).repeat(b)[:b, None, None]
    q = 0.7 * torch.eye(n, device=dev) + noise * torch.randn(
        (b, n, n), generator=gen, device=dev)
    return (term1.to(dtype), q.to(dtype), torch.zeros(b, device=dev),
            torch.full((b,), 3.0, device=dev), _seeds(b, dev), 0.1, 0.9)


@pytest.mark.parametrize("n", [200, 256])
def test_ns_kernel_matches_plain_f32(dev, n):
    """f32: the same arithmetic in another order; q' within 1e-4
    (Frobenius-relative), L within 1e-4; n = 200 exercises ragged tiles."""
    args = _ns_inputs(3, n, dev, torch.float32)
    qk, lk = kernels.fused_ns_update(*args, k=32)
    qp, lp = kernels.fused_ns_update_plain(*args, k=32)
    assert ((qk - qp).norm() / qp.norm()).item() < 1e-4
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)


def test_ns_kernel_matches_plain_bf16(dev):
    """bf16: the kernel rounds product operands to bf16; q' within 1e-2,
    L within 2e-2, and the result is deterministic run to run."""
    args = _ns_inputs(4, 256, dev, torch.bfloat16)
    qk, lk = kernels.fused_ns_update(*args, k=128)
    qp, lp = kernels.fused_ns_update_plain(*args, k=128)
    assert ((qk.float() - qp.float()).norm() / qp.float().norm()).item() < 1e-2
    torch.testing.assert_close(lk, lp, rtol=2e-2, atol=0)
    qk2, lk2 = kernels.fused_ns_update(*args, k=128)
    assert torch.equal(qk, qk2) and torch.equal(lk, lk2)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _both_branches(q1, seeds):
    """Whether the procrustes step of q1, from the plain pieces in f32, is
    clamped at 1/8 for some matrices and a trace ratio below it for others."""
    f = q1.float()
    r = kernels.tsub_plain(f)
    inv = 1.0 / kernels.norm_bound_plain(r, seeds, "skh", kernels.SKH_TAG, k=128)
    rq, tr = kernels.scaled_matmul_trace_plain(r, f, inv)
    a = kernels.step_size(tr, kernels.scaled_matmul_trace_plain(r, rq, inv)[1])
    return bool((a == 0.125).any() and (a < 0.125).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [200, 384])
@pytest.mark.parametrize("route", ["split", "tiled"])
def test_routes_match_plain(dev, route, n, dtype):
    """Each route at a small width (n = 200 exercises the masked edges):
    q' within 1e-4 (f32) or 1e-2 (bf16) Frobenius-relative, L within 1e-4
    or 2e-2, and two runs give the same bits; the procrustes step takes both
    branches."""
    args = _ns_inputs(3, n, dev, dtype)
    assert _both_branches(kernels.ns_step_plain(*args, k=128)[0], args[4])
    qk, lk = kernels.fused_ns_update(*args, k=128, route=route)
    qp, lp = kernels.fused_ns_update_plain(*args, k=128, route=route)
    tol_q, tol_l = kernels.ROUTE_TOL[dtype]
    assert qk.dtype == dtype and _rel(qk, qp) < tol_q
    torch.testing.assert_close(lk, lp, rtol=tol_l, atol=0)
    qk2, lk2 = kernels.fused_ns_update(*args, k=128, route=route)
    assert torch.equal(qk, qk2) and torch.equal(lk, lk2)


def _one_ulp_or_order(got, ref):
    """Products accumulated in f32 in another order: within 1e-5 of the
    largest entry, plus one unit in the last place of each bf16 entry
    (a reordered sum may round to the neighbouring bf16 value)."""
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    diff = (got.float() - ref.float()).abs()
    tol = ulp * ref.float().abs() + 1e-5 * ref.float().abs().max()
    return bool((diff <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [200, 384])
def test_split_stages_match_plain(dev, n, dtype):
    """ns_step and procrustes alone, each on the same inputs as its plain
    version (procrustes on the kernel's q1): q1 to f32 accumulation order,
    L and q' at the route tolerances."""
    term1, q, lips, term2, seeds, lr, beta = _ns_inputs(3, n, dev, dtype)
    q1k, lk = kernels.ns_step(term1, q, lips, term2, seeds, lr, beta, k=128)
    q1p, lp = kernels.ns_step_plain(term1, q, lips, term2, seeds, lr, beta, k=128)
    tol_q, tol_l = kernels.ROUTE_TOL[dtype]
    assert q1k.dtype == dtype and _one_ulp_or_order(q1k, q1p)
    torch.testing.assert_close(lk, lp, rtol=tol_l, atol=0)
    qk = kernels.procrustes(q1k, seeds, k=128)
    qp = kernels.procrustes_plain(q1k, seeds, k=128)
    assert qk.dtype == dtype and _rel(qk, qp) < tol_q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [200, 384])
def test_tiled_pieces_match_plain(dev, n, dtype):
    """Each tiled piece on the same inputs as its plain version: tsub and
    combine bit for bit; tiled_step and scaled_matmul_trace to f32
    accumulation order, traces within 1e-4 of the sum of |diagonal|;
    norm_bound within ``kernels.norm_bound_rtol`` of the plain bound (the
    same start; 1e-5, or twice as far as the plain version moves with its
    sums rounded exactly) and at most 1.001 x the true norm; combine on a
    step that takes both branches and on a fixed one."""
    term1, q, lips, term2, seeds, _, _ = _ns_inputs(3, n, dev, dtype)
    for mat, mode, tag in ((term1, "spd", 0), (q.mT - q, "skh", kernels.SKH_TAG)):
        mat = mat.contiguous()
        bk = kernels.norm_bound(mat, seeds, mode, tag, k=128)
        bp = kernels.norm_bound_plain(mat, seeds, mode, tag, k=128)
        rtol = kernels.norm_bound_rtol(mat, seeds, mode, tag, k=128)
        torch.testing.assert_close(bk, bp, rtol=rtol, atol=0)
        true = torch.linalg.matrix_norm(mat.double(), ord=2)
        assert (bk.double() <= 1.001 * true).all(), (bk, true)
    coeff = torch.full((3,), 0.02, device=dev)
    q1 = kernels.tiled_step(term1, q, coeff, term2)
    assert _one_ulp_or_order(q1, kernels.tiled_step_plain(term1, q, coeff, term2))
    r = kernels.tsub(q1)
    assert torch.equal(r, kernels.tsub_plain(q1))
    inv = 1.0 / kernels.norm_bound(r, seeds, "skh", kernels.SKH_TAG, k=128)
    rq, tr = kernels.scaled_matmul_trace(r, q1, inv)
    rq_p, tr_p = kernels.scaled_matmul_trace_plain(r, q1, inv)
    assert _one_ulp_or_order(rq, rq_p)
    scale = torch.diagonal(r.float() @ q1.float(), dim1=-2, dim2=-1).abs().sum(-1) * inv
    assert ((tr - tr_p).abs() <= 1e-4 * scale).all(), (tr, tr_p)
    rrq, tr2 = kernels.scaled_matmul_trace(r, rq, inv)
    a = kernels.step_size(tr, tr2)
    assert (a == 0.125).any() and (a < 0.125).any(), a
    for a in (a, torch.tensor([0.125, 0.05, -0.01], device=dev)):
        assert torch.equal(kernels.combine(q1, rq, rrq, a),
                           kernels.combine_plain(q1, rq, rrq, a))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [200, 384, 2048])
def test_ns_step_on_tensor_cores(dev, n, b):
    """ns_step in bf16 runs its step product and its bound's thin products
    on the tensor-core GEMM: q1 to f32 accumulation order against the plain
    version (n = 200 exercises TMA's zero-filled edges and the masked
    stores), L' at the route tolerance, and two runs give the same bits."""
    args = _ns_inputs(b, n, dev, torch.bfloat16)
    q1, lk = kernels.ns_step(*args, k=128)
    q1p, lp = kernels.ns_step_plain(*args, k=128)
    assert q1.dtype == torch.bfloat16 and _one_ulp_or_order(q1, q1p)
    torch.testing.assert_close(lk, lp, rtol=kernels.ROUTE_TOL[torch.bfloat16][1], atol=0)
    q1b, lkb = kernels.ns_step(*args, k=128)
    assert torch.equal(q1, q1b) and torch.equal(lk, lkb)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [200, 384, 2048])
def test_scaled_matmul_trace_on_tensor_cores(dev, n, b):
    """scaled_matmul_trace in bf16 on the tensor-core GEMM: R Q to f32
    accumulation order, the trace (from the 128 x 128 diagonal tiles'
    partials) within 1e-4 of the sum of |diagonal| (it cancels), and two
    runs give the same bits."""
    _, q, _, _, _, _, _ = _ns_inputs(b, n, dev, torch.bfloat16)
    r = kernels.tsub_plain(q).contiguous()
    inv = torch.linspace(0.5, 2.0, b, device=dev)
    rq, tr = kernels.scaled_matmul_trace(r, q, inv)
    rq_p, tr_p = kernels.scaled_matmul_trace_plain(r, q, inv)
    assert rq.dtype == torch.bfloat16 and _one_ulp_or_order(rq, rq_p)
    scale = torch.diagonal(r.float() @ q.float(), dim1=-2, dim2=-1).abs().sum(-1) * inv
    assert ((tr - tr_p).abs() <= 1e-4 * scale).all(), (tr, tr_p)
    rq2, tr2 = kernels.scaled_matmul_trace(r, q, inv)
    assert torch.equal(rq, rq2) and torch.equal(tr, tr2)


# q' of the FFMA procrustes chain against its plain version, Frobenius-
# relative, on the split route at (22, 2048) in bf16 on an H100 (PERF.md,
# Findings): the tensor-core chain reads the same bf16 operands, so it may
# not be more than twice as far.
_FFMA_PROCRUSTES_REL = 3.23e-4


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [200, 384, 2048])
def test_procrustes_on_tensor_cores(dev, n, b):
    """procrustes in bf16 runs its skew bound's thin products and its two
    full products on the tensor-core GEMM, which read bf16 copies of R and
    RQ: q' within the route tolerance of the plain version and within twice
    the FFMA chain's error (n = 200 exercises TMA's zero-filled edges, the
    masked stores and a ragged 128-row trace tile), the step taking both
    branches, and two runs give the same bits.  B = 1 runs the two
    alternate-noise matrices as two stacks of one."""
    args = _ns_inputs(max(b, 2), n, dev, torch.bfloat16)
    q1, seeds = kernels.ns_step_plain(*args, k=128)[0], args[4]
    assert _both_branches(q1, seeds)
    stacks = [(q1, seeds)] if b > 1 else [(q1[i:i + 1], seeds[i:i + 1]) for i in range(2)]
    tol = min(kernels.ROUTE_TOL[torch.bfloat16][0], 2 * _FFMA_PROCRUSTES_REL)
    for q1s, s in stacks:
        qk = kernels.procrustes(q1s, s, k=128)
        rel = _rel(qk, kernels.procrustes_plain(q1s, s, k=128))
        assert qk.dtype == torch.bfloat16 and rel < tol, rel
        assert torch.equal(qk, kernels.procrustes(q1s, s, k=128))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [200, 384, 2048])
def test_tiled_step_on_tensor_cores(dev, n, b):
    """tiled_step in bf16 on the tensor-core GEMM with the step epilogue:
    q1 to f32 accumulation order against the plain version (n = 200
    exercises TMA's zero-filled edges and the masked stores), and two runs
    give the same bits."""
    term1, q, _, term2, _, _, _ = _ns_inputs(b, n, dev, torch.bfloat16)
    coeff = torch.linspace(0.01, 0.03, b, device=dev)
    q1 = kernels.tiled_step(term1, q, coeff, term2)
    q1p = kernels.tiled_step_plain(term1, q, coeff, term2)
    assert q1.dtype == torch.bfloat16 and _one_ulp_or_order(q1, q1p)
    assert torch.equal(q1, kernels.tiled_step(term1, q, coeff, term2))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [200, 768, 1024])
def test_single_route_on_tensor_cores(dev, n, b):
    """The single route in bf16 at n % 8 == 0 runs every product on the
    tensor-core GEMM (q1 kept in f32 with a bf16 copy): q' within the route
    tolerance of the plain version, and within twice the FFMA chain's error
    at the shapes where it was logged (``kernels.FFMA_SINGLE_REL``; n = 200
    exercises TMA's zero-filled edges, the masked stores and a
    ragged 128-row trace tile), L' at the route tolerance, the bound at most
    1.001 x the true norm, the step taking both branches, and two runs give
    the same bits.  B = 1 runs the two alternate-noise matrices as two
    stacks of one."""
    args = _ns_inputs(max(b, 2), n, dev, torch.bfloat16)
    assert kernels.ns_route(n, torch.bfloat16) == "single"
    assert _both_branches(kernels.ns_step_plain(*args, k=128)[0], args[4])
    rest = args[5:]
    stacks = [args[:5]] if b > 1 else [tuple(t[i:i + 1] for t in args[:5]) for i in range(2)]
    for stack in stacks:
        tol_q = kernels.ROUTE_TOL[torch.bfloat16][0]
        if (len(stack[0]), n) in kernels.FFMA_SINGLE_REL:
            tol_q = min(tol_q, 2 * kernels.FFMA_SINGLE_REL[len(stack[0]), n])
        qk, lk = kernels.fused_ns_update(*stack, *rest, k=128)
        qp, lp = kernels.fused_ns_update_plain(*stack, *rest, k=128)
        rel = _rel(qk, qp)
        assert qk.dtype == torch.bfloat16 and rel < tol_q, rel
        torch.testing.assert_close(lk, lp, rtol=kernels.ROUTE_TOL[torch.bfloat16][1], atol=0)
        # lips = 0, so L' = ell = bound + term2
        true = torch.linalg.matrix_norm(stack[0].double(), ord=2)
        assert ((lk - stack[3]).double() <= 1.001 * true).all(), (lk, true)
        qk2, lk2 = kernels.fused_ns_update(*stack, *rest, k=128)
        assert torch.equal(qk, qk2) and torch.equal(lk, lk2)


def test_single_route_odd_width_on_ffma(dev):
    """A bf16 width n % 8 != 0 that the single route is sent (the route for
    "anything else") takes the FFMA chain by the shape rule: q' and L' at
    the route tolerances against the plain version."""
    args = _ns_inputs(3, 100, dev, torch.bfloat16)
    qk, lk = kernels.fused_ns_update(*args, k=128)
    qp, lp = kernels.fused_ns_update_plain(*args, k=128)
    tol_q, tol_l = kernels.ROUTE_TOL[torch.bfloat16]
    assert qk.dtype == torch.bfloat16 and _rel(qk, qp) < tol_q
    torch.testing.assert_close(lk, lp, rtol=tol_l, atol=0)


@pytest.mark.parametrize("mode", ["spd", "skh"])
@pytest.mark.parametrize("n", [200, 2560])
def test_norm_bound_on_tensor_cores(dev, n, mode):
    """norm_bound in bf16 runs its four thin products on the tensor-core
    GEMM, the stored matrix its own operand: within
    ``kernels.norm_bound_rtol`` of the plain bound (the same start, the same
    storage-dtype energies) and at most 1.001 x the true norm; n = 200
    exercises the zero-filled edges."""
    term1, q, _, _, seeds, _, _ = _ns_inputs(2, n, dev, torch.bfloat16)
    mat, tag = (term1, 0) if mode == "spd" else ((q.mT - q).contiguous(), kernels.SKH_TAG)
    bk = kernels.norm_bound(mat, seeds, mode, tag, k=128)
    bp = kernels.norm_bound_plain(mat, seeds, mode, tag, k=128)
    rtol = kernels.norm_bound_rtol(mat, seeds, mode, tag, k=128)
    torch.testing.assert_close(bk, bp, rtol=rtol, atol=0)
    true = torch.linalg.matrix_norm(mat.double(), ord=2)
    assert (bk.double() <= 1.001 * true).all(), (bk, true)


@pytest.mark.parametrize("mode", ["spd", "skh"])
@pytest.mark.parametrize("b,n", [(3, 100), (1, 204), (2, 7)])
def test_norm_bound_bf16_odd_width_on_ffma(dev, b, n, mode):
    """norm_bound in bf16 at a width n % 8 != 0 (which TMA cannot load)
    runs its thin products on the FFMA GEMM, its iterates rounded to bf16
    as they are loaded: within ``kernels.norm_bound_rtol`` (BOUND_RTOL at
    such a width: the plain version's sums) of the plain bound, and at most
    (1 + 2^-8) x the true norm: the last thin product reads the unit
    iterate rounded to bf16, each entry within bf16's unit roundoff 2^-8,
    which a width of 7 does not average away (observed 1.0021 at (2, 7)
    spd, H100 80GB HBM3)."""
    term1, q, _, _, seeds, _, _ = _ns_inputs(b, n, dev, torch.bfloat16)
    mat, tag = (term1, 0) if mode == "spd" else ((q.mT - q).contiguous(), kernels.SKH_TAG)
    bk = kernels.norm_bound(mat, seeds, mode, tag, k=128)
    bp = kernels.norm_bound_plain(mat, seeds, mode, tag, k=128)
    rtol = kernels.norm_bound_rtol(mat, seeds, mode, tag, k=128)
    assert rtol == kernels.BOUND_RTOL
    torch.testing.assert_close(bk, bp, rtol=rtol, atol=0)
    true = torch.linalg.matrix_norm(mat.double(), ord=2)
    assert (bk.double() <= (1 + 2 ** -8) * true).all(), (bk, true)


def test_tensor_core_widths_refused(dev):
    """TMA needs 16-byte rows: a bf16 width that is not a multiple of 8 is
    refused by the four tensor-core wrappers that have no FFMA chain for it
    (the single route and norm_bound take it on the FFMA GEMM); f32 at
    that width runs (FFMA)."""
    for dtype in (torch.bfloat16, torch.float32):
        args = _ns_inputs(1, 204, dev, dtype)
        term1, q, lips, term2, seeds = args[:5]
        calls = (lambda: kernels.ns_step(*args, k=32)[0],
                 lambda: kernels.scaled_matmul_trace(q, q, lips + 1.0)[0],
                 lambda: kernels.procrustes(q, seeds, k=32),
                 lambda: kernels.tiled_step(term1, q, lips + 0.02, term2))
        for call in calls:
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match="multiples of 8"):
                    call()
            else:
                assert torch.isfinite(call()).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    term1, q, lips, term2, seeds, lr, beta = _ns_inputs(1, 64, dev, torch.float32)
    with pytest.raises(ValueError):
        kernels.fused_ns_update(term1, q, lips, term2, seeds, lr, beta,
                                starts=(q[:, :8], q[:, :8]))
    with pytest.raises(TypeError):
        kernels.fused_ns_update(term1.half(), q.half(), lips, term2, seeds,
                                lr, beta)
    with pytest.raises(ValueError):
        kernels.fused_ns_update(term1, q.transpose(1, 2), lips, term2, seeds,
                                lr, beta)
    with pytest.raises(TypeError):
        kernels.damped_noise(q.half(), seeds, 1e-9)
    with pytest.raises(ValueError):       # a complex g takes four seed words
        kernels.damped_noise(q.to(torch.complex64), seeds, 1e-9)
    with pytest.raises(ValueError):
        kernels.fused_ns_update(term1, q, lips, term2, seeds, lr, beta,
                                route="monolith")
    with pytest.raises(ValueError):
        kernels.ns_step(term1, q, lips, term2, seeds, lr, beta,
                        start=q[:, :8])
    with pytest.raises(TypeError):
        kernels.procrustes(q.double(), seeds)
    with pytest.raises(ValueError):
        kernels.norm_bound(q[:, :32], seeds)          # not square
    with pytest.raises(TypeError):
        kernels.tiled_step(term1, q.to(torch.bfloat16), lips, term2)
    with pytest.raises(ValueError):
        kernels.tsub(q.transpose(1, 2))               # not contiguous
    with pytest.raises(TypeError):
        kernels.scaled_matmul_trace(q, q, lips.double())
    with pytest.raises(ValueError):
        kernels.combine(q, q, q[:, :32], lips)
    assert np.isfinite(kernels.fused_ns_update(
        term1, q, lips, term2, seeds, lr, beta)[1].cpu().numpy()).all()


def _newton_inputs(b, n, dev, dtype):
    """The Newton fit's call: the bound's matrix A + B and the step matrix
    S = A - B (A from ``_ns_inputs``, B a Wishart matrix), both stored in
    Q's dtype, term2 = 0."""
    term1, q, lips, _, seeds, lr, beta = _ns_inputs(b, n, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(n + 1)
    w = torch.randn((b, n, n), generator=gen, device=dev)
    bb = w @ w.mT / n
    return ((term1 + bb).to(dtype), q.to(dtype), lips, torch.zeros(b, device=dev),
            seeds, lr, beta), (term1 - bb).to(dtype)


_STEP_MAT_COUNTER = {"single": kernels.fused_ns_update, "split": kernels.ns_step,
                     "tiled": kernels.tiled_step}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [200, 384, 2048])
@pytest.mark.parametrize("route", ["single", "split", "tiled"])
def test_step_mat_matches_plain(dev, route, n, b, dtype):
    """The step-matrix variant of each route (the TPU kernels'
    has_step_mat; S differs from term1): q' and L' at the route tolerances
    of the plain version given the same S, the launch counted in the
    route's ``step_mat_launches``, two runs give the same bits, and
    ``step_mat=None`` gives the bits of the call without it."""
    args, s = _newton_inputs(b, n, dev, dtype)
    counter = _STEP_MAT_COUNTER[route]
    before = counter.step_mat_launches
    qk, lk = kernels.fused_ns_update(*args, k=128, route=route, step_mat=s)
    assert counter.step_mat_launches == before + 1
    qp, lp = kernels.fused_ns_update_plain(*args, k=128, route=route, step_mat=s)
    tol_q, tol_l = kernels.ROUTE_TOL[dtype]
    assert qk.dtype == dtype and _rel(qk, qp) < tol_q, _rel(qk, qp)
    torch.testing.assert_close(lk, lp, rtol=tol_l, atol=0)
    without = kernels.fused_ns_update_plain(*args, k=128, route=route)[0]
    assert _rel(without, qp) > 2 * tol_q       # S moves q' by ~5%
    qk2, lk2 = kernels.fused_ns_update(*args, k=128, route=route, step_mat=s)
    assert torch.equal(qk, qk2) and torch.equal(lk, lk2)
    q0, l0 = kernels.fused_ns_update(*args, k=128, route=route)
    qn, ln = kernels.fused_ns_update(*args, k=128, route=route, step_mat=None)
    assert torch.equal(q0, qn) and torch.equal(l0, ln)
    assert counter.step_mat_launches == before + 2


def test_step_mat_is_checked(dev):
    """A step matrix in another dtype, shape or device is refused before a
    launch, on each of the three wrappers that take one."""
    args, s = _newton_inputs(2, 64, dev, torch.float32)
    term1, q, lips, term2 = args[:4]
    for bad, err in ((s.double(), TypeError), (s[:1], ValueError),
                     (s.cpu(), ValueError)):
        for call in (lambda: kernels.fused_ns_update(*args, route="single", step_mat=bad),
                     lambda: kernels.ns_step(*args, step_mat=bad),
                     lambda: kernels.tiled_step(bad, q, lips + 0.02, term2, True)):
            with pytest.raises(err):
                call()


@pytest.mark.parametrize("n", [2304, 2560, 3072])
def test_tiled_route_one_layer_wide(dev, n):
    """The tiled route at B = 1 and the widths of GPT-2 124M's shared stacks
    (2304 = 18 x 128, 3072 = 24 x 128, bf16) and of LLaMA-1.1B's wqkv
    factor on each rank of the tensor-parallel path (2560, its one layer
    there): q' and L' within the route
    tolerances of the plain route, the same bits twice, the spd bound at
    most 1.001 x the true norm."""
    assert kernels.ns_route(n, torch.bfloat16) == "tiled"
    args = _ns_inputs(1, n, dev, torch.bfloat16)
    qk, lk = kernels.fused_ns_update(*args, k=128)
    qp, lp = kernels.fused_ns_update_plain(*args, k=128)
    tol_q, tol_l = kernels.ROUTE_TOL[torch.bfloat16]
    assert qk.dtype == torch.bfloat16 and _rel(qk, qp) < tol_q
    torch.testing.assert_close(lk, lp, rtol=tol_l, atol=0)
    qk2, lk2 = kernels.fused_ns_update(*args, k=128)
    assert torch.equal(qk, qk2) and torch.equal(lk, lk2)
    bound = kernels.norm_bound(args[0], args[4], "spd", 0, k=128)
    true = torch.linalg.matrix_norm(args[0].double(), ord=2)
    assert (bound.double() <= 1.001 * true).all(), (bound, true)


@pytest.mark.parametrize("shape,stack", [((768, 2304), None), ((64, 96), 3),
                                         ((4, 48, 40), None)])
def test_precond_grad_cached_on_cuda(dev, shape, stack):
    """The cached apply on the card in bf16 (max_skew 2: (768, 2304) is
    dense x diagonal, the others all dense, a stack of 3): the cache is
    Q^T Q in f32 to bf16 rounding, and P g through it agrees with the
    uncached Q then Q^T chain within sqrt(3 * 4 order) bf16 unit roundoffs
    (4 order roundings to bf16 on the two chains, each of RMS u / sqrt(3),
    at 3 sigma), Frobenius-relative."""
    from psgd_torch_tpu_torch.precond import kron as kron_p
    gen = torch.Generator(device=dev).manual_seed(len(shape))
    plan = kron_p.make_kron_plan(shape, max_skew=2.0)
    lead = () if stack is None else (stack,)
    qs = tuple((1.0 + 0.1 * torch.randn(lead + (n,), generator=gen, device=dev))
               if diag else (torch.eye(n, device=dev) + 0.1 * torch.randn(
                   lead + (n, n), generator=gen, device=dev) / n ** 0.5)
               for n, diag in zip(plan.shape, plan.is_diag))
    st = kron_p.KronState(q=tuple(q.to(torch.bfloat16) for q in qs), lips=())
    g = torch.randn(lead + shape, generator=gen, device=dev).to(torch.bfloat16)
    pc = kron_p.compute_p_factors(st, plan)
    for q, p, diag in zip(st.q, pc, plan.is_diag):
        ref = q.float() ** 2 if diag else q.float().mT @ q.float()
        assert p.dtype == torch.bfloat16 and _one_ulp_or_order(p, ref)
    if stack is None:
        cached = kron_p.precond_grad_cached(pc, plan, g)
        chain = kron_p.precond_grad(st, plan, g)
    else:
        cached = kron_p.precond_grad_cached_stacked(pc, plan, g)
        chain = kron_p.precond_grad_stacked(st, plan, g)
    assert cached.dtype == torch.bfloat16 and cached.shape == g.shape
    assert _rel(cached, chain) < (12 * plan.order) ** 0.5 * 2.0 ** -8


@pytest.mark.parametrize("newton", [False, True])
@pytest.mark.parametrize("dq", ["EQ", "QEP", "QEQ", "QUAD", "QUAD4P", "PRO4P"])
def test_geometry_fit_launches_the_kernels(dev, dq, newton):
    """A stacked fit (B = 3, (16, 40): one dense and one diagonal factor,
    f32) of each of the six other geometries on the card launches the
    port's kernels and nothing quietly plain: one spd norm_bound for the
    dense factor (PRO4P 10 more skew ones and 10 tsub, its masked loop),
    the damping by damped_noise (EQ whitening: its probe by unit_noise),
    no NS kernel; Q and L agree with the CPU's plain fit from the same
    state and keys within 1e-4 (f32 sums in another order).  A float64
    stack on the card takes the XLA tail's bounds (PyTorch operations,
    their starts ``philox_start`` launches) and the noise kernel's float64
    instantiation, no bound kernel, and agrees with the CPU's within
    1e-10."""
    from psgd_torch_tpu_torch.ops import fastrand
    from psgd_torch_tpu_torch.precond import kron
    plan = kron.make_kron_plan((16, 40), max_skew=2.0, dq=dq)
    rng = np.random.default_rng(7)
    q = (torch.from_numpy(np.eye(16) + 0.05 * rng.standard_normal((3, 16, 16))),
         torch.from_numpy(1.0 + 0.05 * rng.standard_normal((3, 40))))
    if dq == "EQ":
        q = (torch.triu(q[0]), q[1])
    st = kron.KronState(q=tuple(f.float() for f in q),
                        lips=(torch.ones(3), torch.ones(3)))
    g, v = (torch.from_numpy(rng.standard_normal((3, 16, 40))).float()
            for _ in range(2))
    keys = fastrand.split(fastrand.prng_key(3), 3)

    def fit(state, device):
        on = kron.KronState(tuple(f.to(device) for f in state.q),
                            tuple(l.to(device) for l in state.lips))
        dt = state.q[0].dtype
        if newton:
            return kron.update_kron_newton_stacked(
                on, plan, v.to(device, dt), g.to(device, dt), keys, norm_k=8)
        return kron.update_kron_whiten_stacked(on, plan, g.to(device, dt), keys,
                                               norm_k=8)

    kernels.reset_launch_counts()
    out = fit(st, dev)
    loop = 10 if dq == "PRO4P" else 0
    eq_probe = dq == "EQ" and not newton
    assert kernels.norm_bound.launches == 1 + loop
    assert kernels.tsub.launches == loop
    assert kernels.damped_noise.launches == (0 if eq_probe else 1)
    assert kernels.unit_noise.launches == (1 if eq_probe else 0)
    assert kernels.fused_ns_update.launches == 0 and kernels.ns_step.launches == 0
    ref = fit(st, "cpu")
    for a, b in zip(out.q + out.lips, ref.q + ref.lips):
        assert a.device.type == "cuda"
        assert (a.cpu() - b).norm() <= 1e-4 * b.norm(), dq
    st64 = kron.KronState(tuple(f.double() for f in st.q),
                          tuple(l.double() for l in st.lips))
    kernels.reset_launch_counts()
    out = fit(st64, dev)
    assert kernels.norm_bound.launches == 0 and kernels.tsub.launches == 0
    assert kernels.philox_start.launches == 1 + loop
    assert kernels.damped_noise.launches == (0 if eq_probe else 1)
    assert kernels.unit_noise.launches == (1 if eq_probe else 0)
    ref = fit(st64, "cpu")
    for a, b in zip(out.q + out.lips, ref.q + ref.lips):
        assert a.dtype == torch.float64
        assert (a.cpu() - b).norm() <= 1e-10 * b.norm(), dq


# GPT-2 124M's parameter count: the length of the LRA paths' flat vector
GPT2_124M_PARAMS = 124_475_904


def test_noise_unit_and_fused_give_one_v_at_the_lra_width(dev):
    """Row 2 at (1, 124.5M) f32, the LRA whitening fit's shape: unit and
    fused mode from the same seeds give the same v (the fused output is
    g + (damping + eps|g|) v with the unit draw's v, bit for bit), and
    both are the plain versions' bits."""
    n, damping = GPT2_124M_PARAMS, 1e-3
    seeds = _seeds(1, dev)
    g = torch.randn((1, n), device=dev)
    v = kernels.unit_noise(seeds, (n,), torch.float32)
    fused = kernels.damped_noise(g, seeds, damping)
    eps = torch.finfo(torch.float32).eps
    d = torch.tensor(damping, dtype=torch.float32, device=dev) + eps * g.abs()
    assert _same_bits(fused, g + d * v)
    del d
    assert _same_bits(v, kernels.unit_noise_plain(seeds, (n,), torch.float32))
    assert _same_bits(fused, kernels.damped_noise_plain(g, seeds, damping))


@pytest.mark.parametrize("n", [100, 1700])
def test_procrustes_f32_at_the_dense_widths(dev, n):
    """Row 4 at (1, n, n) f32, the dense Q0.5EQ1.5 fit's shapes (Rosenbrock
    n = 100, the tensor-rank problem n = 1700, neither a multiple of 64):
    the FFMA chain within ROUTE_TOL f32 of procrustes_plain (the same
    arithmetic in another order), from a Q with a skew part, and two runs
    give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn((1, n, n), generator=gen, device=dev) / n ** 0.5
    q1 = torch.eye(n, device=dev) + 0.05 * (a + a.mT) + 0.02 * (a - a.mT)
    seeds = _seeds(1, dev)
    for k in (32, 128):
        qk = kernels.procrustes(q1, seeds, k=k)
        rel = _rel(qk, kernels.procrustes_plain(q1, seeds, k=k))
        assert qk.dtype == torch.float32 and rel < kernels.ROUTE_TOL[torch.float32][0], rel
        assert torch.equal(qk, kernels.procrustes(q1, seeds, k=k))


@pytest.mark.parametrize("name", ["LRAWhiten", "LRANewton", "DenseNewton"])
def test_flat_optimizers_launch_the_kernels(dev, name):
    """One fit step of each flat optimizer on the card (a 3-leaf problem,
    f32) launches the port's kernels: LRAWhiten one unit_noise and one
    damped_noise, LRANewton and DenseNewton one unit_noise per leaf and
    one damped_noise, DenseNewton's Q0.5EQ1.5 one procrustes; the
    parameters agree with the CPU's plain run within 1e-4."""
    from psgd_torch_tpu_torch import optim
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=gen) for s in ((2, 30), (2, 40), (2, 50))]
    target = torch.randn((30, 40, 50), generator=gen)

    def run(device):
        params = [x.clone().to(device).requires_grad_() for x in init]
        tgt = target.to(device)
        loss = lambda: ((tgt - torch.einsum("ri,rj,rk->ijk", *params)) ** 2).sum()
        opt = getattr(optim, name)(params, lr=0.01, device=device,
                                   preconditioner_init_scale=1.0)
        kernels.reset_launch_counts()
        if name == "LRAWhiten":
            loss().backward()
            opt.step()
        else:
            opt.step(loss)
        return torch.cat([p.detach().flatten().cpu() for p in params])

    on_card = run(dev)
    counts = {k: getattr(kernels, k).launches
              for k in ("unit_noise", "damped_noise", "procrustes")}
    expected = {"LRAWhiten": (1, 1, 0), "LRANewton": (3, 1, 0),
                "DenseNewton": (3, 1, 1)}[name]
    assert tuple(counts.values()) == expected, counts
    ref = run("cpu")
    assert (on_card - ref).norm() <= 1e-4 * ref.norm()


def test_checkpoint_resumes_bf16_state_on_the_card(dev, tmp_path):
    """A tiny GPT-2 with the trainer's PSGD recipe on the card (bf16 Q and
    momentum, f32 parameters), checkpointed after 2 steps and restored into
    a fresh model and optimizer: every restored tensor keeps its dtype
    (bf16 Q and momentum, f32 Lipschitz estimates), and fed the unbroken
    run's gradients for 2 more steps the restored optimizer lands on the
    same parameters and state bit for bit."""
    from psgd_torch_tpu_torch.examples import train_gpt2
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.utils import checkpoint

    cfg = gpt2.tiny_config(n_layer=2, n_head=2, n_embd=64, block_size=32,
                           vocab_size=128)

    def fresh(seed):
        model = gpt2.GPT2(cfg, device=dev, seed=seed)
        return model, train_gpt2.psgd_optimizer(model, 4, dev, seed=1)

    model, opt = fresh(0)
    grads = []
    for i in range(4):
        if i == 2:
            checkpoint.save_checkpoint(str(tmp_path), 2, model, opt)
        x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(i), 2,
                                       cfg.block_size, cfg.vocab_size, device=dev)
        opt.zero_grad(set_to_none=True)
        gpt2.loss_gpt2(model, x, y).backward()
        if i >= 2:
            grads.append([p.grad.clone() for p in opt.param_groups[0]["params"]])
        opt.step()
    model2, opt2 = fresh(3)
    assert checkpoint.restore_checkpoint(str(tmp_path), model2, opt2)[0] == 2
    for st in opt2.state.values():
        assert {q.dtype for q in st["q"]} == {torch.bfloat16}
        assert {x.dtype for x in st["lips"]} == {torch.float32}
        assert st["mu"].dtype == torch.bfloat16 and st["mu"].device == dev
    for gs in grads:
        for p, g in zip(opt2.param_groups[0]["params"], gs):
            p.grad = g
        opt2.step()
    for a, b in zip(opt.param_groups[0]["params"], opt2.param_groups[0]["params"]):
        assert torch.equal(a, b)
    for p, p2 in zip(opt.param_groups[0]["params"], opt2.param_groups[0]["params"]):
        for k, v in opt.state[p].items():
            for x, y in zip(v if isinstance(v, tuple) else (v,),
                            opt2.state[p2][k] if isinstance(v, tuple) else (opt2.state[p2][k],)):
                assert x.dtype == y.dtype and torch.equal(x, y), k
    assert (opt.count, opt.fit_steps) == (opt2.count, opt2.fit_steps)
    assert (opt.key == opt2.key).all()
