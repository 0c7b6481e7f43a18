"""The arithmetic of the bf16 flash backward kernels
(``fa_bwd_dq_wgmma_kernel`` and ``fa_bwd_dkv_wgmma_kernel`` in
``mxtpu_torch/csrc/flash_attention_bwd.cu``), emulated in plain PyTorch
on the CPU, and why they split P and dS.

The kernels run on the card only; their products are bf16 tensor-core
products with f32 accumulation.  S = Q.K^T and dP = dO.V^T (and their
transposes) take bf16 inputs exactly.  P and dS are f32 and the
reference never rounds them, so before the products that take them
(dV += P^T.dO and dK += dS^T.Q, tile of 64 query rows by tile; dQ +=
dS.K, tile of 64 keys by tile) each is split into two bf16 parts, x =
bf16(x) + bf16(x - bf16(x)), whose products go into one f32
accumulator.  The emulations below do the same and are held, under the
card's bf16 gate (``chip_smoke.py``: |r - p| <= 2e-2 * max(min(1, rms
p), |p|)), against mxtpu's Pallas backward in interpret mode (T <= 256)
and against the port's f32 plain version at causal T = 1024.  With one
rounding instead of the split, dk/dv's causal T = 1024 case misses that
gate, and so does dq's: the reason the kernels take each of P and dS
as two products a tile (dk/dv six products, dq four).
"""
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

tfa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
jfa = importlib.import_module("mxtpu.kernels.flash_attention")

torch.set_num_threads(2)

TILE = 64  # query rows per tile, as in the kernel


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    monkeypatch.setenv("MXTPU_FLASH_BWD", "pallas")


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulated_dkv(q, k, v, do, o, lse, causal, scale, split=True):
    """dk, dv (bf16) as the kernel computes them from bf16 q, k, v, dO
    (BH, T, D), the forward's O and lse."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    Tq, Tk = q.shape[1], k.shape[1]
    diag = Tk - Tq
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    keys = torch.arange(Tk)[:, None]
    for q0 in range(0, Tq, TILE):
        rows = slice(q0, min(q0 + TILE, Tq))
        st = torch.matmul(kf, qf[:, rows].transpose(1, 2))
        p = torch.exp(st * scale - lse[:, None, rows])
        if causal:
            seen = keys <= torch.arange(q0, rows.stop)[None, :] + diag
            p = torch.where(seen, p, torch.zeros_like(p))
        dpt = torch.matmul(vf, dof[:, rows].transpose(1, 2))
        dst = p * (dpt - delta[:, None, rows]) * scale
        for x, b, acc in ((p, dof[:, rows], dv), (dst, qf[:, rows], dk)):
            hi = _bf16(x)
            acc += torch.matmul(hi, b)
            if split:
                acc += torch.matmul(_bf16(x - hi), b)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def emulated_dq(q, k, v, do, o, lse, causal, scale, split=True):
    """dq (bf16) as the kernel computes it from bf16 q, k, v, dO (BH, T,
    D), the forward's O and lse: tiles of 64 keys, dS in f32 split hi +
    lo, f32 accumulation, one rounding at the end."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    Tq, Tk = q.shape[1], k.shape[1]
    diag = Tk - Tq
    dq = torch.zeros_like(qf)
    rows = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, TILE):
        keys = slice(k0, min(k0 + TILE, Tk))
        s = torch.matmul(qf, kf[:, keys].transpose(1, 2))
        p = torch.exp(s * scale - lse[..., None])
        if causal:
            seen = torch.arange(k0, keys.stop)[None, :] <= rows + diag
            p = torch.where(seen, p, torch.zeros_like(p))
        dp = torch.matmul(dof, vf[:, keys].transpose(1, 2))
        ds = p * (dp - delta[..., None]) * scale
        hi = _bf16(ds)
        dq += torch.matmul(hi, kf[:, keys])
        if split:
            dq += torch.matmul(_bf16(ds - hi), kf[:, keys])
    return dq.to(torch.bfloat16)


def _inputs(seed, BH, T, D, causal):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(BH, T, D).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / D ** 0.5
    o, lse = tfa.flash_forward_reference(q, k, v, causal, scale)
    return q, k, v, do, o, lse, scale


def _gate(got, want):
    """The card's bf16 gradient check: max relative error, with the
    floor min(1, rms(want))."""
    floor = chip_smoke.scale_floor(want, "bfloat16")
    return chip_smoke.rel_err(got.float(), want.float(), floor)[0]


@pytest.mark.parametrize("causal,T", [(False, 128), (True, 128),
                                      (True, 256), (False, 192)])
def test_split_matches_pallas_backward(causal, T):
    q, k, v, do, o, lse, scale = _inputs(0, 2, T, 64, causal)
    dk, dv = emulated_dkv(q, k, v, do, o, lse, causal, scale)
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (q, k, v, do)]
    rows = jnp.sum(j[3].astype(jnp.float32) *
                   jnp.asarray(o.float().numpy()), -1)[..., None]
    _, wk, wv = jfa._flash_backward(*j, jnp.asarray(lse.numpy())[..., None],
                                    rows, causal, scale, True)
    for got, want in ((dk, wk), (dv, wv)):
        want = torch.from_numpy(np.asarray(want, np.float32))
        assert torch.isfinite(got.float()).all()
        assert _gate(got, want) <= chip_smoke.TOL["bfloat16"]


@pytest.mark.parametrize("causal,Tq,Tk", [(False, 128, 128),
                                          (True, 128, 128),
                                          (True, 256, 256),
                                          (False, 192, 192),
                                          (True, 64, 192),
                                          (False, 130, 70)])
def test_dq_split_matches_pallas_backward(causal, Tq, Tk):
    rng = np.random.RandomState(3)
    q, do = (torch.from_numpy(rng.randn(2, Tq, 64).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, Tk, 64).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    scale = 1.0 / 8.0
    o, lse = tfa.flash_forward_reference(q, k, v, causal, scale)
    dq = emulated_dq(q, k, v, do, o, lse, causal, scale)
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (q, k, v, do)]
    rows = jnp.sum(j[3].astype(jnp.float32) *
                   jnp.asarray(o.float().numpy()), -1)[..., None]
    wq, _, _ = jfa._flash_backward(*j, jnp.asarray(lse.numpy())[..., None],
                                   rows, causal, scale, True)
    want = torch.from_numpy(np.asarray(wq, np.float32))
    assert dq.shape == want.shape and torch.isfinite(dq.float()).all()
    assert _gate(dq, want) <= chip_smoke.TOL["bfloat16"]


def _long_causal_dq(split):
    q, k, v, do, o, lse, scale = _inputs(1, 2, 1024, 64, True)
    dq = emulated_dq(q, k, v, do, o, lse, True, scale, split)
    wq, _, _ = tfa.flash_backward_reference(
        *(t.float() for t in (q, k, v, do, o)), lse, True, scale)
    return _gate(dq, wq)


def test_dq_split_passes_gate_long_causal():
    assert _long_causal_dq(split=True) <= chip_smoke.TOL["bfloat16"]


def test_dq_one_rounding_misses_gate_long_causal():
    # one bf16 rounding of dS costs dq 2.2e-2 here, the split 3.9e-3
    assert _long_causal_dq(split=False) > chip_smoke.TOL["bfloat16"]


def _long_causal(split):
    q, k, v, do, o, lse, scale = _inputs(1, 2, 1024, 64, True)
    dk, dv = emulated_dkv(q, k, v, do, o, lse, True, scale, split)
    _, wk, wv = tfa.flash_backward_reference(
        *(t.float() for t in (q, k, v, do, o)), lse, True, scale)
    return max(_gate(dk, wk), _gate(dv, wv))


def test_split_passes_gate_long_causal():
    assert _long_causal(split=True) <= chip_smoke.TOL["bfloat16"]


def test_one_rounding_misses_gate_long_causal():
    assert _long_causal(split=False) > chip_smoke.TOL["bfloat16"]


# one bf16 rounding of the output, in bf16; in f32 the zero columns may
# change only the CPU's summation order
PAD_TOL = {torch.bfloat16: dict(rtol=2 ** -8, atol=1e-6),
           torch.float32: dict(rtol=1e-5, atol=1e-6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_zero_padding_along_d_changes_nothing(dtype):
    """The wrappers run the TMA kernels (forward and backward, f32 and
    bf16) on copies zero-padded along D to a multiple of 8 (TMA's row
    stride), with the scale of the true D: the padded
    forward and backward, sliced back, are the unpadded ones (up to one
    bf16 rounding of the output in bf16: the zero columns may change
    the CPU's summation order)."""
    q, k, v, do, o, lse, scale = _inputs(2, 3, 70, 42, True)
    q, k, v, do, o = (t.to(dtype) for t in (q, k, v, do, o))
    if dtype == torch.float32:
        o, lse = tfa.flash_forward_reference(q, k, v, True, scale)
    pq, pk, pv, pdo = tfa._pad_d(q, k, v, do)
    assert pq.shape[-1] == 48 and not pq[..., 42:].any()
    assert pq.dtype == dtype
    po, plse = tfa.flash_forward_reference(pq, pk, pv, True, scale)
    one = PAD_TOL[dtype]
    torch.testing.assert_close(po[..., :42].float(), o.float(), **one)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
    want = tfa.flash_backward_reference(q, k, v, do, o, lse, True, scale)
    got = tfa.flash_backward_reference(pq, pk, pv, pdo, po, plse, True,
                                       scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :42].float(), w.float(), **one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_unaligned_bf16_inputs_are_refused(dtype):
    """TMA reads from 16-byte aligned addresses; the wrappers raise on
    any other rather than copy (forward and backward, f32 and bf16)."""
    from mxtpu_torch import MXNetError
    buf = torch.zeros(2 * 64 + 1, dtype=dtype)
    tfa._aligned(buf[:64])
    with pytest.raises(MXNetError, match="16-byte"):
        tfa._aligned(buf[:64], buf[1:65])
