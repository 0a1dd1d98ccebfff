"""The port's kernels against the reference, on the CPU.

Each plain PyTorch version (what the port's ``ops`` run on a CPU tensor) is
held against the JAX Pallas kernel in interpret mode and against the JAX
``ref.py``, on the same numpy inputs, with the shape and beta sweeps and
the tolerances of ``tests/test_kernels.py``. The CUDA kernels themselves
need the card: ``chip_smoke.py`` holds them against these plain versions
there. Also checked here: dispatch never launches for a CPU tensor and
never falls back, the build raises with nvcc's output, and the port
imports nothing of JAX or the reference package.
"""
import ast
import math
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fa_kernel
from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.modulus import kernel as mod_kernel
from repro.kernels.modulus import ref as mod_ref
from repro.kernels.overlap import kernel as ov_kernel
from repro.kernels.overlap import ref as ov_ref
from repro.kernels.raar import kernel as raar_kernel
from repro.kernels.raar import ref as raar_ref
from repro_torch import kernels as t_kernels
from repro_torch.kernels import _build
from repro_torch.kernels.art import kernel as t_art_kernel
from repro_torch.kernels.art import ops as t_art_ops
from repro_torch.kernels.flash_attention import kernel as t_fa_kernel
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.modulus import kernel as t_mod_kernel
from repro_torch.kernels.modulus import ops as t_mod_ops
from repro_torch.kernels.overlap import kernel as t_ov_kernel
from repro_torch.kernels.overlap import ops as t_ov_ops
from repro_torch.kernels.raar import kernel as t_raar_kernel
from repro_torch.kernels.raar import ops as t_raar_ops
from repro_torch.utils import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _planes(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _seed(*parts):
    return zlib.crc32(repr(parts).encode())


def _c(re, im):
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im))


def _close(got, want_re, want_im, tol):
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want_re),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(want_im),
                               rtol=tol, atol=tol)


# -- modulus -------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 16, 16), (7, 32, 32), (16, 8, 24),
                                   (1, 64, 64)])
@pytest.mark.parametrize("fb", [2, 16])
def test_torch_modulus_sweep(shape, fb):
    re, im, mag = _planes(_seed("modulus", shape), shape, 3)
    mag = np.abs(mag)
    got = t_mod_ops.modulus_project(_c(re, im), torch.from_numpy(mag))
    pallas = mod_kernel.modulus_project(jnp.asarray(re), jnp.asarray(im),
                                        jnp.asarray(mag), block_frames=fb,
                                        interpret=True)
    ref = mod_ref.modulus_project_ref(jnp.asarray(re), jnp.asarray(im),
                                      jnp.asarray(mag))
    for want in (pallas, ref):
        _close(got, *want, tol=1e-6)


def test_torch_modulus_projection_property():
    """|π₁ψ| == measured magnitude (the modulus constraint, paper eq. 1)."""
    re, im, mag = _planes(0, (3, 16, 16), 3)
    mag = np.abs(mag) + 0.1
    out = t_mod_ops.modulus_project(_c(re, im), torch.from_numpy(mag))
    np.testing.assert_allclose(out.abs().numpy(), mag, rtol=1e-4, atol=1e-4)


# -- raar ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 16, 16), (5, 8, 40)])
@pytest.mark.parametrize("beta", [0.5, 0.75, 0.9])
def test_torch_raar_sweep(shape, beta):
    planes = _planes(_seed("raar", shape), shape, 8)
    fields = [_c(planes[2 * k], planes[2 * k + 1]) for k in range(4)]
    got = t_raar_ops.raar_combine(*fields, beta=beta)
    jp = [jnp.asarray(p) for p in planes]
    pallas = raar_kernel.raar_combine(*jp, beta=beta, block_frames=3,
                                      interpret=True)
    ref = raar_ref.raar_combine_ref(*jp, beta=beta)
    for want in (pallas, ref):
        _close(got, *want, tol=1e-6)


@pytest.mark.parametrize("beta", [0.5, 0.75, 0.9])
def test_torch_raar_aliased_p2_is_p21(beta):
    """The solver passes one tensor as p21 and p2 (SHARP's single-overlap
    approximation); the result is still the four-input function."""
    planes = _planes(_seed("raar-alias", beta), (3, 8, 8), 6)
    psi, p1, p21 = (_c(planes[2 * k], planes[2 * k + 1]) for k in range(3))
    got = t_raar_ops.raar_combine(psi, p1, p21, p21, beta=beta)
    want = raar_ref.raar_combine_complex(
        *(jnp.asarray(z.numpy()) for z in (psi, p1, p21, p21)), beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# -- overlap -------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 16, 16), (9, 24, 8)])
def test_torch_overlap_sweep(shape):
    a_re, a_im, b_re, b_im = _planes(_seed("overlap", shape), shape, 4)
    num, den = t_ov_ops.overlap_products(_c(a_re, a_im), _c(b_re, b_im))
    jp = [jnp.asarray(p) for p in (a_re, a_im, b_re, b_im)]
    pallas = ov_kernel.overlap_products(*jp, block_frames=4, interpret=True)
    ref = ov_ref.overlap_products_ref(*jp)
    for n_re, n_im, d in (pallas, ref):
        _close(num, n_re, n_im, tol=1e-6)
        np.testing.assert_allclose(den.numpy(), np.asarray(d),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 16, 16), (9, 24, 8)])
def test_torch_overlap_shared_probe(shape):
    """The object update's b is one (H, W) probe for every frame: the port
    reads it in place; the reference broadcasts it into an (F, H, W) copy."""
    a_re, a_im = _planes(_seed("overlap-a", shape), shape, 2)
    b_re, b_im = _planes(_seed("overlap-b", shape), shape[1:], 2)
    num, den = t_ov_ops.overlap_products(_c(a_re, a_im), _c(b_re, b_im))
    jp = [jnp.asarray(a_re), jnp.asarray(a_im),
          jnp.broadcast_to(jnp.asarray(b_re), shape),
          jnp.broadcast_to(jnp.asarray(b_im), shape)]
    n_re, n_im, d = ov_kernel.overlap_products(*jp, block_frames=4,
                                               interpret=True)
    assert num.shape == den.shape == shape
    _close(num, n_re, n_im, tol=1e-6)
    np.testing.assert_allclose(den.numpy(), np.asarray(d),
                               rtol=1e-6, atol=1e-6)


def test_torch_overlap_matches_complex_ref():
    a_re, a_im, b_re, b_im = _planes(3, (3, 8, 8), 4)
    num, den = t_ov_ops.overlap_products(_c(a_re, a_im), _c(b_re, b_im))
    num_c, den_c = ov_ref.overlap_products_complex(
        jnp.asarray(a_re + 1j * a_im), jnp.asarray(b_re + 1j * b_im))
    np.testing.assert_allclose(num.numpy(), np.asarray(num_c),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_c),
                               rtol=1e-5, atol=1e-5)


# -- flash attention -----------------------------------------------------------
def _to_jax(x, dtype):
    return jnp.asarray(x, dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("S,hd,bq,bkv", [(64, 16, 16, 32), (128, 32, 32, 32),
                                         (32, 8, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_flash_attention_sweep(S, hd, bq, bkv, dtype):
    """The plain version against the JAX ``attention_ref`` and the Pallas
    kernel in interpret mode, on the sweep and tolerances of
    tests/test_kernels.py:124-139 (fp32 1e-5, bf16 2e-2). The bf16 inputs
    are the same fp32 draws rounded to bf16 by each package."""
    q, k, v = _planes(_seed("flash", S, hd), (4, S, hd), 3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = t_fa_ref.attention_ref(*(_to_torch(x, td) for x in (q, k, v)),
                                 causal=True)
    jq, jk, jv = (_to_jax(x, jd) for x in (q, k, v))
    pallas = fa_kernel.flash_attention_bhsd(jq, jk, jv, block_q=bq,
                                            block_kv=bkv, causal=True,
                                            interpret=True)
    ref = fa_ref.attention_ref(jq, jk, jv, causal=True)
    assert got.dtype == td and got.shape == (4, S, hd)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (pallas, ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_torch_flash_attention_model_layout():
    """``ops`` in the (B, S, H, hd) layout, S = 40 not a multiple of the
    kernel's 64-row tiles (the reference pads it to its blocks), against the
    JAX ``naive_attention`` at 2e-5, as tests/test_kernels.py:142-156."""
    from repro.models.attention import naive_attention
    B, S, H, hd = 2, 40, 4, 16
    q, k, v = _planes(_seed("flash-layout"), (B, S, H, hd), 3)
    got = t_fa_ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           pos, pos, causal=True)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_torch_flash_attention_ref_keeps_the_bottom_right_mask():
    """At Sq < Skv the reference's plain version aligns the causal mask
    bottom-right (``tril(k=Skv - Sq)``), which the port reproduces; the
    kernel's top-left mask agrees with it only at Sq = Skv."""
    q, = _planes(_seed("flash-rect-q"), (2, 8, 16), 1)
    k, v = _planes(_seed("flash-rect-kv"), (2, 24, 16), 2)
    got = t_fa_ref.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)))
    want = fa_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _wgmma_model(q, k, v, bkv=128):
    """The arithmetic of csrc/flash_attention_wgmma.cu on (BH, S, hd)
    tensors: 128-row q tiles, ``bkv``-row kv tiles up to causal reach (128
    at hd 64 and 128, 64 at hd 256), scores in fp32 scaled and masked (top-left,
    and the tail past S), the online max and sum in fp32, P split into two
    bf16 terms, hi = bf16(P) and lo = bf16(P - hi), before P.V (fp32
    products and sums), the sum clamped at 1e-30, the output rounded once
    to bf16."""
    BH, S, hd = q.shape
    qf, kf, vf = (x.float() for x in (q, k, v))
    out = torch.empty_like(qf)
    scale = 1.0 / math.sqrt(hd)
    for q0 in range(0, S, 128):
        qt = qf[:, q0:q0 + 128]
        rows = torch.arange(q0, q0 + qt.shape[1])[:, None]
        m = torch.full((BH, qt.shape[1]), -1e30)
        l = torch.zeros((BH, qt.shape[1]))
        acc = torch.zeros((BH, qt.shape[1], hd))
        for k0 in range(0, min(q0 + 128, S), bkv):
            s = qt @ kf[:, k0:k0 + bkv].transpose(1, 2) * scale
            cols = torch.arange(k0, k0 + s.shape[2])[None, :]
            s = s.masked_fill(~(cols <= rows), -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(s == -1e30, 0.0, torch.exp(s - m_new[..., None]))
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            acc = (acc * alpha[..., None] + hi @ vf[:, k0:k0 + bkv]
                   + lo @ vf[:, k0:k0 + bkv])
            m = m_new
        out[:, q0:q0 + 128] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("S,block", [(64, 64), (130, None), (256, 128)])
def test_torch_flash_wgmma_numerics_match_the_reference(S, block):
    """The wgmma kernel's numerics (P as two bf16 terms before P.V),
    modelled here, against the JAX ``attention_ref`` and, where S tiles
    evenly, the Pallas kernel in interpret mode, within the bf16 tolerance
    of tests/test_kernels.py:136 (2e-2); S 130 runs a ragged second
    tile."""
    q, k, v = _planes(_seed("flash-wgmma", S), (2, S, 128), 3)
    tq, tk, tv = (_to_torch(x, torch.bfloat16) for x in (q, k, v))
    got = _wgmma_model(tq, tk, tv)
    jq, jk, jv = (_to_jax(x, jnp.bfloat16) for x in (q, k, v))
    wants = [fa_ref.attention_ref(jq, jk, jv, causal=True)]
    if block is not None:
        wants.append(fa_kernel.flash_attention_bhsd(
            jq, jk, jv, block_q=block, block_kv=block, causal=True,
            interpret=True))
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, 128)
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("S,block", [(64, 64), (130, None), (256, 128)])
def test_torch_flash_wgmma_hd256_numerics_match_the_reference(S, block):
    """The wgmma kernel's numerics at gemma-7b's hd 256, with its 64-key kv
    tiles, against the JAX ``attention_ref`` and, where S tiles evenly, the
    Pallas kernel in interpret mode at hd 256, within 2e-2; 128-key tiles
    give the same function within the same tolerance."""
    q, k, v = _planes(_seed("flash-wgmma-256", S), (2, S, 256), 3)
    tq, tk, tv = (_to_torch(x, torch.bfloat16) for x in (q, k, v))
    got = _wgmma_model(tq, tk, tv, bkv=64)
    jq, jk, jv = (_to_jax(x, jnp.bfloat16) for x in (q, k, v))
    wants = [fa_ref.attention_ref(jq, jk, jv, causal=True)]
    if block is not None:
        wants.append(fa_kernel.flash_attention_bhsd(
            jq, jk, jv, block_q=block, block_kv=block, causal=True,
            interpret=True))
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, 256)
    wants.append(_wgmma_model(tq, tk, tv, bkv=128).float())
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("S,block", [(64, 64), (130, None), (256, 128)])
def test_torch_flash_wgmma_hd64_numerics_match_the_reference(S, block):
    """The wgmma kernel's numerics at granite-moe-3b-a800m's hd 64, with
    128-key kv tiles, against the JAX ``attention_ref`` and, where S tiles
    evenly, the Pallas kernel in interpret mode at hd 64, within 2e-2."""
    q, k, v = _planes(_seed("flash-wgmma-64", S), (2, S, 64), 3)
    tq, tk, tv = (_to_torch(x, torch.bfloat16) for x in (q, k, v))
    got = _wgmma_model(tq, tk, tv, bkv=128)
    jq, jk, jv = (_to_jax(x, jnp.bfloat16) for x in (q, k, v))
    wants = [fa_ref.attention_ref(jq, jk, jv, causal=True)]
    if block is not None:
        wants.append(fa_kernel.flash_attention_bhsd(
            jq, jk, jv, block_q=block, block_kv=block, causal=True,
            interpret=True))
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, 64)
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


def _tf32(x):
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the bits are sign and magnitude, so adding
    half of the dropped 13 bits' range rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_products(a, b, products):
    """a @ b as the tf32x3 kernel's mma.sync issues it: each operand split
    as big + small (both TF32), then small.big, big.small and big.big
    summed in that order into one fp32 accumulator; ``products=1`` is the
    single big.big product of plain TF32."""
    a_big, b_big = _tf32(a), _tf32(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    acc = a_small @ b_big
    acc = acc + a_big @ b_small
    return acc + a_big @ b_big


def _tf32x3_model(q, k, v, products=3):
    """The arithmetic of csrc/flash_attention_tf32x3.cu on (BH, S, hd) fp32
    tensors: 64-row q tiles, 64-row kv tiles up to causal reach, S = Q.K^T
    and O += P.V in split TF32 (``_tf32_products``), scores scaled and
    masked (top-left, and the tail past S), the online max and sum in
    fp32, the sum clamped at 1e-30, the output divided once."""
    BH, S, hd = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for q0 in range(0, S, 64):
        qt = q[:, q0:q0 + 64]
        rows = torch.arange(q0, q0 + qt.shape[1])[:, None]
        m = torch.full((BH, qt.shape[1]), -1e30)
        l = torch.zeros((BH, qt.shape[1]))
        acc = torch.zeros((BH, qt.shape[1], hd))
        for k0 in range(0, min(q0 + 64, S), 64):
            s = _tf32_products(qt, k[:, k0:k0 + 64].transpose(1, 2),
                               products) * scale
            cols = torch.arange(k0, k0 + s.shape[2])[None, :]
            s = s.masked_fill(~(cols <= rows), -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(s == -1e30, 0.0, torch.exp(s - m_new[..., None]))
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + _tf32_products(p, v[:, k0:k0 + 64], products))
            m = m_new
        out[:, q0:q0 + 64] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out


@pytest.mark.parametrize("S,hd", [(64, 16), (128, 32), (32, 8), (130, 128),
                                  (130, 256), (130, 64)])
def test_torch_flash_tf32x3_numerics_match_the_reference(S, hd):
    """The tf32x3 kernel's numerics (split TF32 products), modelled here,
    against the JAX ``attention_ref`` and the Pallas kernel in interpret
    mode, within the fp32 tolerance of tests/test_kernels.py:136 (1e-5), at
    ``chip_smoke.FLASH_SHAPES`` and a ragged S of 130 at hd 128, at
    gemma-7b's hd 256 and at granite-moe-3b-a800m's hd 64 (a third q and
    kv tile of 2 rows)."""
    q, k, v = _planes(_seed("flash-tf32x3", S, hd), (4, S, hd), 3)
    got = _tf32x3_model(*(torch.from_numpy(x) for x in (q, k, v)))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = fa_kernel.flash_attention_bhsd(jq, jk, jv, causal=True,
                                            interpret=True)
    ref = fa_ref.attention_ref(jq, jk, jv, causal=True)
    assert got.dtype == torch.float32 and got.shape == (4, S, hd)
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_torch_flash_one_tf32_product_misses_the_fp32_tolerance():
    """Why the kernel issues three products: a single TF32 product (11
    bits of each operand) misses the fp32 tolerance of 1e-5 by two orders
    of magnitude at S 130, hd 128, where split TF32 holds it (above)."""
    q, k, v = _planes(_seed("flash-tf32x3", 130, 128), (4, 130, 128), 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = np.asarray(fa_ref.attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True))
    one = _tf32x3_model(tq, tk, tv, products=1).numpy()
    three = _tf32x3_model(tq, tk, tv).numpy()
    assert np.abs(one - want).max() > 1e-4
    assert np.abs(three - want).max() < 1e-5
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-5)


def test_torch_tf32_rounding_is_to_nearest_ties_away():
    """The model's ``cvt.rna.tf32.f32``: 1 + 2^-11 (half a TF32 step) rounds
    up, 1 + 2^-11 - 2^-23 down, and the negative of each by magnitude."""
    x = torch.tensor([1 + 2.0**-11, 1 + 2.0**-11 - 2.0**-23, 1 + 2.0**-10,
                      -(1 + 2.0**-11), 3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + 2.0**-10, 1.0, 1 + 2.0**-10,
                                 -(1 + 2.0**-10), 3.0]


@pytest.mark.parametrize("dtype,hd,design", [
    (torch.bfloat16, 128, "wgmma"), (torch.float32, 128, "tf32x3"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 8, "tf32x3"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 256, "tf32x3"),
    (torch.bfloat16, 64, "wgmma"), (torch.float32, 64, "tf32x3")])
def test_torch_flash_wrapper_picks_the_kernel_by_type_and_head_dim(
        dtype, hd, design):
    """bf16 at hd 64, 128 and 256 (the prefills) goes to the wgmma kernel,
    every fp32 call to the tf32x3 one, bf16 at the small head dims to the
    SIMT one; on a CPU tensor each raises before counting."""
    assert t_fa_kernel.design_for(dtype, hd) == design
    t_kernels.reset_launch_counts()
    x = torch.ones((1, 4, 2, hd), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa_kernel.flash_attention(x, x, x)
    assert t_fa_kernel.flash_attention.launches_by_design == {
        "wgmma": 0, "tf32x3": 0, "simt": 0}
    assert (design, hd) in t_fa_kernel.INSTANCES
    assert not any(t_fa_kernel.flash_attention.launches_by_instance.values())


def test_torch_flash_instances_are_the_built_pairs():
    """The per-instance counter has one key a built (design, head dim)
    pair: tf32x3 at every head dim, wgmma at 64, 128 and 256, simt at the
    small ones."""
    want = {("tf32x3", hd) for hd in t_fa_kernel.HEAD_DIMS}
    want |= {("wgmma", 64), ("wgmma", 128), ("wgmma", 256), ("simt", 8),
             ("simt", 16), ("simt", 32)}
    assert set(t_fa_kernel.INSTANCES) == want
    assert set(t_fa_kernel.flash_attention.launches_by_instance) == want


@pytest.mark.parametrize("hd", t_fa_kernel.HEAD_DIMS)
def test_torch_flash_every_fp32_call_goes_to_tf32x3(hd):
    """No fp32 call reaches the SIMT kernel: one fp32 path."""
    assert t_fa_kernel.design_for(torch.float32, hd) == "tf32x3"


@pytest.mark.parametrize("hd", [48, 96, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_torch_flash_unbuilt_head_dim_raises(hd, dtype):
    """No kernel is built at a head dim outside ``HEAD_DIMS`` (48, 96 and
    512 here; no ported arch has one): ``design_for`` raises
    ``ValueError`` instead of picking one."""
    assert hd not in t_fa_kernel.HEAD_DIMS
    with pytest.raises(ValueError, match=f"head_dim {hd} not built"):
        t_fa_kernel.design_for(dtype, hd)


def test_torch_reset_launch_counts_resets_the_designs():
    t_fa_kernel.flash_attention.launches_by_design["wgmma"] = 3
    t_fa_kernel.flash_attention.launches_by_design["tf32x3"] = 2
    t_fa_kernel.flash_attention.launches_by_instance["wgmma", 256] = 3
    t_kernels.reset_launch_counts()
    assert t_fa_kernel.flash_attention.launches_by_design == {
        "wgmma": 0, "tf32x3": 0, "simt": 0}
    assert t_fa_kernel.flash_attention.launches_by_instance == dict.fromkeys(
        t_fa_kernel.INSTANCES, 0)


# -- dispatch ------------------------------------------------------------------
def _cpu_calls():
    z = torch.ones((2, 4, 4), dtype=torch.complex64)
    mag = torch.ones((2, 4, 4))
    A, b, f0 = torch.ones((6, 8)), torch.ones((2, 6)), torch.zeros((2, 8))
    qkv = torch.ones((1, 5, 2, 8))
    return {
        "modulus_project": (t_mod_ops.modulus_project,
                            t_mod_kernel.modulus_project, (z, mag)),
        "overlap_products": (t_ov_ops.overlap_products,
                             t_ov_kernel.overlap_products, (z, z[0])),
        "raar_combine": (t_raar_ops.raar_combine,
                         t_raar_kernel.raar_combine, (z, z, z, z)),
        "art_sweep": (t_art_ops.art_reconstruct,
                      lambda A, b, f0: t_art_kernel.art_sweep(
                          t_art_ops.csr_rows(A), b, torch.ones(6), f0),
                      (A, b, f0)),
        "flash_attention": (t_fa_ops.flash_attention,
                            t_fa_kernel.flash_attention, (qkv, qkv, qkv)),
    }


def test_torch_ops_on_cpu_tensors_launch_nothing():
    t_kernels.reset_launch_counts()
    for op, _, args in _cpu_calls().values():
        op(*args)
    assert t_kernels.launch_counts() == {name: 0 for name in _cpu_calls()}


@pytest.mark.parametrize("name", ["modulus_project", "overlap_products",
                                  "raar_combine", "art_sweep",
                                  "flash_attention"])
def test_torch_kernels_refuse_cpu_tensors(name):
    """A kernel wrapper takes CUDA tensors only, and ``ops`` asked for the
    kernel does not fall back to the plain version."""
    op, kernel_fn, args = _cpu_calls()[name]
    t_kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel_fn(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        op(*args, use_kernel=True)
    assert t_kernels.launch_counts()[name] == 0


def test_torch_resolve_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# -- build ---------------------------------------------------------------------
def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_torch_build_failure_raises_with_nvcc_stderr(tmp_path):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "k.cu").write_text("broken")
    nvcc = _fake_nvcc(tmp_path, 'echo "k.cu(1): error: boom" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.build(tmp_path / "src", tmp_path / "build", nvcc=nvcc)
    assert not list((tmp_path / "build").iterdir())


def test_torch_build_reuses_library_until_a_source_changes(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.cu").write_text("// a")
    (src / "b.cu").write_text("// b")
    calls = tmp_path / "calls"
    # record the arguments, then write the -o target as nvcc would
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {calls}\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\n')
    lib = _build.build(src, tmp_path / "build", nvcc=nvcc)
    # one library for every path's kernels, named after none of them
    assert _build.LIB_NAME == "librepro_torch_kernels.so"
    assert lib.name == _build.LIB_NAME and lib.read_text() == "lib\n"
    first = calls.read_text().splitlines()
    # one nvcc -c a source, then one link of the objects
    compiles = sorted(c for c in first if " -c " in c)
    links = [c for c in first if "-shared" in c]
    assert len(first) == 3 and len(compiles) == 2 and len(links) == 1
    assert "a.cu" in compiles[0] and "b.cu" in compiles[1]
    assert all("sm_90a" in c and "--use_fast_math" not in c for c in first)
    assert ".cu" not in links[0]
    _build.build(src, tmp_path / "build", nvcc=nvcc)
    assert len(calls.read_text().splitlines()) == 3
    (src / "b.cu").write_text("// b, edited")
    _build.build(src, tmp_path / "build", nvcc=nvcc)
    assert len(calls.read_text().splitlines()) == 6


@pytest.mark.parametrize("name,bound", [
    ("modulus", "Bound: device memory"),
    ("overlap", "Bound: device memory"),
    ("raar", "Bound: device memory"),
    ("art", "Bound: the dependent chain of row steps"),
    ("art", "the CSR's column indices and values once a sweep"),
    ("flash_attention", "Bound: operations, at the fp32 FMA rate"),
    ("flash_attention_wgmma", "Bound: device memory"),
    ("flash_attention_wgmma", "wgmma.m64n128k16"),
    ("flash_attention_wgmma", "wgmma.mma_async.sync.aligned.m64n64k16"),
    ("flash_attention_wgmma", "wgmma.mma_async.sync.aligned.m64n256k16"),
    ("flash_attention_tf32x3", "Bound: operations"),
    ("flash_attention_tf32x3", "mma.sync.aligned.m16n8k8.row.col.f32.tf32"),
])
def test_torch_kernel_sources_name_the_tpu_kernel_they_replace(name, bound):
    text = (ROOT / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    replaced = name.removesuffix("_wgmma").removesuffix("_tf32x3")
    assert f"repro/kernels/{replaced}/kernel.py" in text
    assert bound in text
    assert 'extern "C"' in text


# -- import rule ---------------------------------------------------------------
def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_torch_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the compute plane keeps its own copies of the reference's modules
    # that import no JAX (pmi, compression): they are walked too
    for module in ("core/pmi.py", "core/bridge.py", "core/fault.py",
                   "optim/compression.py", "checkpoint/ckpt.py",
                   "apps/quickstart.py"):
        assert ROOT / "src" / "repro_torch" / module in files, module
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert bad == []
