"""Randomness of the port: the host threefry key tree against jax.random,
and the Philox noise (plain version here; the CUDA kernel on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu_torch.ops import fastrand, kernels, philox

SQRT3 = 3.0 ** 0.5


def test_threefry_keys_match_jax():
    """split / fold_in / uniform01 equal jax.random bit for bit (float32
    uniform, the gate's type without x64)."""
    for seed in (0, 1, 123456789, 2 ** 40 + 5):
        k = fastrand.prng_key(seed)
        jk = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(k, np.asarray(jk))
        np.testing.assert_array_equal(fastrand.split(k, 3),
                                      np.asarray(jax.random.split(jk, 3)))
        for d in (0, 7, 101, 2 ** 31 + 3):
            np.testing.assert_array_equal(
                fastrand.fold_in(k, d), np.asarray(jax.random.fold_in(jk, d)))
    keys = fastrand.split(fastrand.prng_key(9), 12)
    np.testing.assert_array_equal(
        fastrand.split(keys), np.asarray(jax.vmap(jax.random.split)(keys)))
    u = fastrand.uniform01(keys)
    ref = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(keys)
    np.testing.assert_array_equal(u, np.asarray(ref))


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 library."""
    m = philox.M32
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((m, m, m, m), (m, m),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        t = [torch.tensor([c], dtype=torch.int64) for c in ctr + key]
        got = [int(x) for x in philox.philox4x32_10(*t)]
        assert got == list(want)


def _seeds(n, seed=0):
    keys = fastrand.split(fastrand.prng_key(seed), n)
    return kernels.key_seed_words(keys, "cpu")


def test_stream_depends_only_on_its_seed():
    """Element i is the same whether drawn in a batch of 1 or of 12."""
    seeds = _seeds(12)
    full = kernels.unit_noise(seeds, (5, 13), torch.float32)
    for i in (0, 5, 11):
        one = kernels.unit_noise(seeds[i:i + 1], (5, 13), torch.float32)
        assert torch.equal(full[i], one[0])
    assert not torch.equal(full[0], full[1])
    other = kernels.unit_noise(_seeds(12, seed=1), (5, 13), torch.float32)
    assert not torch.equal(full, other)


def test_unit_noise_distribution():
    """uniform(-sqrt3, sqrt3): |mean| < 0.01 and |var - 1| < 0.01 over 400k
    draws (about 5 standard errors each)."""
    u = kernels.unit_noise(_seeds(4, seed=3), (100_000,), torch.float32)
    assert u.min() > -SQRT3 - 1e-6 and u.max() < SQRT3 + 1e-6
    assert abs(u.mean().item()) < 0.01
    assert abs(u.var().item() - 1.0) < 0.01
    assert (u.abs() > 1.6).float().mean() > 0.05   # uniform, not normal tails


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_damping_equals_g_plus_d_unit(dtype):
    """Fused mode == g + (damping + eps|g|) * (unit mode), exactly, with the
    arithmetic in float32 and one rounding per operation."""
    seeds = _seeds(3, seed=4)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 7, 9))
                         ).to(dtype)
    v = kernels.unit_noise(seeds, (7, 9), dtype).float()
    d = torch.tensor(1e-3, dtype=torch.float32) + torch.finfo(dtype).eps * \
        g.float().abs()
    want = (g.float() + d * v).to(dtype)
    assert torch.equal(kernels.damped_noise(g, seeds, 1e-3), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_noise_is_two_counters_per_eight_elements(dtype):
    """The vector kernel's layout: for a length that is a multiple of 8,
    elements 8m ... 8m + 7 of a batch element are the four words of counter
    2m followed by those of counter 2m + 1 (low counter word only, the high
    one 0), each through the mantissa trick and the scale, in order.  So
    one thread's two Philox calls give its eight elements."""
    seeds = _seeds(3, seed=6)
    n_oct = 40
    want = kernels.unit_noise_plain(seeds, (8 * n_oct,), dtype)
    s = philox.seed_words_u32(seeds)
    m = torch.arange(n_oct, dtype=torch.int64)[None]
    z = torch.zeros_like(m)
    octs = []
    for ctr in (2 * m, 2 * m + 1):
        octs += philox.philox4x32_10(ctr, z, z, z, s[:, :1], s[:, 1:])
    words = torch.stack(octs, dim=-1).reshape(3, 8 * n_oct)
    got = ((philox._float_in_1_2(words) - 1.5) * philox.UNIT_SCALE).to(dtype)
    assert torch.equal(got, want)
    assert kernels.MAX_NOISE_PER_BATCH == 2 ** 31 - 1   # 8m + 7 in 32 bits


def test_fastrand_noise_routes_to_the_plain_version_on_cpu():
    keys = fastrand.split(fastrand.prng_key(5), 2)
    out = fastrand.unit_noise_stacked(keys, (4, 8), torch.float32, "cpu")
    want = kernels.unit_noise_plain(kernels.key_seed_words(keys, "cpu"),
                                    (4, 8), torch.float32)
    assert torch.equal(out, want)
    one = fastrand.unit_noise(keys[1], (4, 8), torch.float32, "cpu")
    assert torch.equal(one, want[1])
    # a complex draw is the composition of two real ones (split(key))
    c = fastrand.unit_noise(keys[0], (4,), torch.complex64, "cpu")
    kr, ki = fastrand.split(keys[0])
    part = torch.tensor(2 ** -0.5, dtype=torch.float32)
    real = [kernels.unit_noise_plain(kernels.key_seed_words(k, "cpu"), (4,),
                                     torch.float32)[0] * part for k in (kr, ki)]
    assert torch.equal(c, torch.complex(*real))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_noise_is_two_real_draws(dtype):
    """unit_noise_stacked of a complex dtype: layer i's real part is the
    real draw (f32 for complex64, f32 widened to f64 for complex128) keyed
    by kr, its imaginary part that keyed by ki, (kr, ki) = split(keys[i])
    (jax.random.split's keys bit for bit), each times 2^-0.5 rounded once,
    equal bit for bit; the seed words are (kr, ki) per layer."""
    keys = fastrand.split(fastrand.prng_key(8), 3)
    split = fastrand.split(keys)
    np.testing.assert_array_equal(split, np.asarray(jax.vmap(jax.random.split)(keys)))
    np.testing.assert_array_equal(fastrand.noise_keys(keys, dtype),
                                  split.reshape(3, 4))
    out = fastrand.unit_noise_stacked(keys, (5, 7), dtype, "cpu")
    rd = torch.float32 if dtype == torch.complex64 else torch.float64
    part = torch.tensor(2 ** -0.5, dtype=rd)
    for i in range(3):
        re, im = (kernels.unit_noise_plain(kernels.key_seed_words(split[i, j], "cpu"),
                                           (5, 7), rd)[0] * part for j in (0, 1))
        assert out.dtype == dtype and torch.equal(out[i], torch.complex(re, im))
        # per-layer seeds: layer i alone draws the same
        assert torch.equal(fastrand.unit_noise(keys[i], (5, 7), dtype, "cpu"), out[i])
    both = torch.view_as_real(out).reshape(-1, 2)
    assert abs(both.var(0).sum().item() - 1.0) < 0.15      # E|v|^2 = 1
    assert abs(torch.corrcoef(both.T)[0, 1].item()) < 0.15  # parts independent


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_damping_is_per_part(dtype):
    """damped_noise's plain version of a complex g: g + (damping + eps
    hypot(re g, im g)) v per part in the part's dtype, one rounding per
    operation, v the complex unit noise of the (B, 4) seeds; and the
    damping of precond.kron draws it from split(key)."""
    keys = fastrand.split(fastrand.prng_key(9), 2)
    seeds = kernels.key_seed_words(fastrand.noise_keys(keys, dtype), "cpu")
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((2, 6, 5))
                         + 1j * rng.standard_normal((2, 6, 5))).to(dtype)
    rd = torch.float32 if dtype == torch.complex64 else torch.float64
    v = kernels.unit_noise(seeds, (6, 5), dtype)
    d = torch.tensor(1e-3, dtype=rd) + torch.finfo(rd).eps * torch.hypot(g.real, g.imag)
    want = torch.complex(g.real + d * v.real, g.imag + d * v.imag)
    assert torch.equal(kernels.damped_noise(g, seeds, 1e-3), want)
    from psgd_torch_tpu_torch.precond import kron as tkron
    assert torch.equal(tkron._damped_stacked(g, keys, 1e-3), want)


def test_float64_noise_widens_the_float32_draw():
    """float64 unit noise is the float32 draw widened; the damping is
    computed in float64 with one rounding per operation."""
    seeds = _seeds(2, seed=10)
    u64 = kernels.unit_noise(seeds, (9, 4), torch.float64)
    assert u64.dtype == torch.float64
    assert torch.equal(u64, kernels.unit_noise(seeds, (9, 4), torch.float32).double())
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 9, 4)))
    want = g + (torch.tensor(1e-9, dtype=torch.float64)
                + torch.finfo(torch.float64).eps * g.abs()) * u64
    assert torch.equal(kernels.damped_noise(g, seeds, 1e-9), want)


def test_normal_like():
    """normal_like(key, x): unit_noise in x's shape, dtype and device."""
    x = torch.zeros(3, 4, dtype=torch.complex128)
    key = fastrand.prng_key(11)
    out = fastrand.normal_like(key, x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, fastrand.unit_noise(key, (3, 4), torch.complex128, "cpu"))



_SASS = """
        Function : _ZN12_GLOBAL__N_112noise_kernelI13__nv_bfloat16Lb0ELb1EEEvPKT_PS2_PKjxfff
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 EXIT ;                                      /* 0x000000000000894d */
.L_x_1:
        /*0020*/                   IMAD.WIDE.U32 R4, R2, -0x2daee0ad, RZ ;     /* 0x0 */
        /*0030*/                   IMAD.HI.U32 R6, R3, -0x32617299, RZ ;       /* 0x0 */
        /*0040*/                   LOP3.LUT R7, R5, R8, R9, 0x96, !PT ;        /* 0x0 */
        /*0050*/               @P1 BRA `(.L_x_0) ;                             /* 0x0 */
        /*0060*/                   STG.E.128 desc[UR4][R10.64], R12 ;          /* 0x0 */
.L_x_0:
        /*0070*/                   ISETP.GE.U32.AND P0, PT, R2, UR6, PT ;      /* 0x0 */
        /*0080*/              @!P0 BRA `(.L_x_1) ;                             /* 0x0 */
        /*0090*/                   EXIT ;                                      /* 0x0 */
        Function : _ZN12_GLOBAL__N_112noise_kernelIfLb1EEEvPKT_PS1_PKjxfff
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;     /* 0x0 */
        /*0010*/                   STG.E desc[UR4][R2.64], R5 ;                /* 0x0 */
        /*0020*/                   IMAD.HI.U32 R6, R3, -0x32617299, RZ ;       /* 0x0 */
        /*0030*/                   STG.E desc[UR4][R2.64+0x4], R6 ;            /* 0x0 */
        /*0040*/               @P0 BRA.U !UP0, 0x10 ;                          /* 0x0 */
        /*0050*/                   BRA 0x50;                                   /* 0x0 */
        Function : _ZN12_GLOBAL__N_120noise_complex_kernelIfLb1ELb1EEEvPKT_PS1_PKjxfS1_S1_S1_
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;     /* 0x0 */
.L_x_2:
        /*0010*/                   IMAD.WIDE.U32 R4, R2, -0x2daee0ad, RZ ;     /* 0x0 */
        /*0020*/                   STG.E.128 desc[UR4][R2.64], R4 ;            /* 0x0 */
        /*0030*/                   STG.E.128 desc[UR4][R2.64+0x10], R8 ;       /* 0x0 */
        /*0040*/              @!P0 BRA `(.L_x_2) ;                             /* 0x0 */
        /*0050*/                   EXIT ;                                      /* 0x0 */
"""


def test_sass_loop_counts_per_element():
    """The noise bound's instruction term reads the longest backward branch
    of each noise_kernel in a cuobjdump listing (labels or addresses, with
    or without predicates), counting its instructions, IMAD.WIDE/HI and
    stored bytes: 7 instructions and 16 bytes (8 bf16) in the first, 4
    instructions and 8 bytes (2 f32) in the second, whose self-loop at 0x50
    is shorter; the complex mode's loop counts per complex element."""
    from psgd_torch_tpu_torch.ops import sass
    loops = sass.noise_loops_of(sass.split_functions(_SASS))
    vec = loops[("bfloat16", False, True)]
    assert (vec["instructions"], vec["imad_wide_hi"], vec["elements"]) == (7, 2, 8)
    assert vec["per_element"] == 7 / 8 and vec["imad_per_element"] == 2 / 8
    old = loops[("float32", True, None)]
    assert (old["instructions"], old["imad_wide_hi"], old["elements"]) == (4, 1, 2)
    # the complex mode: 32 bytes stored per pass are 4 complex64 elements
    cx = loops[("complex64", True, True)]
    assert (cx["instructions"], cx["imad_wide_hi"], cx["elements"]) == (4, 1, 4)
    with pytest.raises(ValueError, match="no loop"):
        sass.main_loop(["        /*0000*/  EXIT ;"])
