"""The f32 flash backward on the tensor cores (``fa_bwd_dq_f32_wgmma_kernel``
and ``fa_bwd_dkv_f32_wgmma_kernel`` in
``mxtpu_torch/csrc/flash_attention_bwd.cu``), emulated in plain PyTorch
on the CPU.

Both kernels split every f32 operand exactly into three bf16 parts
(``split3``) and take each product as the six part products that
matter, smallest first, into one f32 accumulator, as the f32 forward
does (``tests/test_torch_f32_split.py``).  dq: CTAs of 128 query rows
(64 for D > 64), 64-key tiles up to the last one the CTA's last row
sees; S = Q.K^T and dP = dO.V^T; P = exp(scale*S - lse) and dS = P*(dP
- delta)*scale in f32, never rounded; dQ += dS.K with dS split three
ways.  dk/dv: CTAs of 128 keys (64 for D > 64), 64-row q tiles from
the first one that sees the CTA's first key; S^T = K.Q^T and dP^T =
V.dO^T; dV += P^T.dO and dK += dS^T.Q with P^T and dS^T split three
ways.  The emulations are held to mxtpu's Pallas ``_flash_backward``
in f32 (Precision.HIGHEST), run in interpret mode, and to the port's
plain ``flash_backward_reference`` at a long causal T, under the card's
f32 gate (``chip_smoke.py``: |r - p| <= 1e-4 * max(1, |p|)); with one
bf16 product per product they miss it, which is why the kernels split.
The wrapper runs the f32 kernels, like the bf16 ones, on copies
zero-padded along D to a multiple of 8 and refuses misaligned inputs.
"""
import contextlib
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke  # noqa: E402
from test_torch_f32_split import (GATE, PAIRS, _one_product,  # noqa: E402
                                  _six_products, split3)

tfa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
jfa = importlib.import_module("mxtpu.kernels.flash_attention")

torch.set_num_threads(2)

TILE = 64   # rows of a streamed tile: keys in dq, query rows in dk/dv


def six_into(acc, a, b):
    """acc + a @ b as the kernels take it: the six part products,
    smallest first, each added into the f32 accumulator."""
    pa, pb = split3(a.contiguous()), split3(b.contiguous())
    for i, j in PAIRS:
        acc = acc + torch.matmul(pa[i], pb[j])
    return acc


def one_into(acc, a, b):
    """acc + a @ b with one bf16 product: each side rounded once."""
    return acc + _one_product(a, b)


def _owned_rows(D):
    """Rows (dq) or keys (dk/dv) a CTA owns: two warpgroups of 64 for
    D <= 64, one above."""
    return 128 if D <= 64 else 64


def emulated_dq(q, k, v, do, lse, drows, causal, scale, delta=None,
                one=False):
    """dq of ``fa_bwd_dq_f32_wgmma_kernel`` from f32 q, dO (BH, Tq, D),
    k, v (BH, Tk, D), the forward's lse and delta = rowsum(dO * O)."""
    fresh, into = (_one_product, one_into) if one else \
        (_six_products, six_into)
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    d = Tk - Tq if delta is None else delta
    R = _owned_rows(D)
    dq = torch.zeros(BH, Tq, D)
    for q0 in range(0, Tq, R):
        r = slice(q0, min(q0 + R, Tq))
        rows = torch.arange(q0, r.stop)[:, None]
        nk = (Tk + TILE - 1) // TILE
        if causal:
            last = q0 + R - 1 + d
            nk = min(nk, 0 if last < 0 else last // TILE + 1)
        acc = torch.zeros(BH, r.stop - q0, D)
        for t in range(nk):
            keys = torch.arange(t * TILE, min(t * TILE + TILE, Tk))
            s = fresh(q[:, r], k[:, keys].transpose(1, 2)) * scale
            p = torch.exp(s - lse[:, r, None])
            if causal:
                p = torch.where(keys[None, :] <= rows + d, p,
                                torch.zeros_like(p))
            dp = fresh(do[:, r], v[:, keys].transpose(1, 2))
            ds = p * (dp - drows[:, r, None]) * scale
            acc = into(acc, ds, k[:, keys])
        dq[:, r] = acc
    return dq


def emulated_dkv(q, k, v, do, lse, drows, causal, scale, delta=None,
                 one=False):
    """(dk, dv) of ``fa_bwd_dkv_f32_wgmma_kernel`` from the same
    inputs."""
    fresh, into = (_one_product, one_into) if one else \
        (_six_products, six_into)
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    d = Tk - Tq if delta is None else delta
    R = _owned_rows(D)
    nq = (Tq + TILE - 1) // TILE
    dk = torch.zeros(BH, Tk, D)
    dv = torch.zeros(BH, Tk, D)
    for k0 in range(0, Tk, R):
        kr = slice(k0, min(k0 + R, Tk))
        keys = torch.arange(k0, kr.stop)[:, None]
        t0 = 0
        if causal:   # q tile t sees key k0 iff 64 t + 63 + d >= k0
            first = k0 - d - (TILE - 1)
            t0 = 0 if first <= 0 else (first + TILE - 1) // TILE
        ak = torch.zeros(BH, kr.stop - k0, D)
        av = torch.zeros(BH, kr.stop - k0, D)
        for t in range(t0, nq):
            rows = torch.arange(t * TILE, min(t * TILE + TILE, Tq))
            st = fresh(k[:, kr], q[:, rows].transpose(1, 2)) * scale
            p = torch.exp(st - lse[:, None, rows])
            if causal:
                p = torch.where(keys <= rows[None, :] + d, p,
                                torch.zeros_like(p))
            dpt = fresh(v[:, kr], do[:, rows].transpose(1, 2))
            dst = p * (dpt - drows[:, None, rows]) * scale
            av = into(av, p, do[:, rows])
            ak = into(ak, dst, q[:, rows])
        dk[:, kr], dv[:, kr] = ak, av
    return dk, dv


def _inputs(seed, BH, Tq, Tk, D, causal, delta=None):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(BH, Tq, D).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(BH, Tk, D).astype(np.float32))
            for _ in range(2))
    scale = 1.0 / D ** 0.5
    o, lse = tfa.flash_forward_reference(q, k, v, causal, scale, delta)
    drows = (do * o).sum(-1)
    return q, k, v, do, o, lse, drows, scale


def _pallas_backward(q, k, v, do, lse, drows, causal, scale, delta):
    j = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
    got = jfa._flash_backward(*j, jnp.asarray(lse.numpy())[..., None],
                              jnp.asarray(drows.numpy())[..., None],
                              causal, scale, True, delta=delta)
    return [torch.from_numpy(np.array(g)) for g in got]


# (causal, Tq, Tk, D, delta): full and causal tiles, two CTAs of rows
# and of keys, D = 128 and 96 (64-row CTAs, two column boxes), D = 32
# and 40 (one box, zeros past D), Tq != Tk both ways (rows that see no
# key when Tq > Tk), explicit diagonals
CASES = [(False, 128, 128, 64, None), (True, 128, 128, 64, None),
         (True, 256, 256, 64, None), (False, 192, 192, 128, None),
         (True, 64, 192, 32, None), (True, 130, 70, 96, None),
         (True, 96, 160, 64, 3), (False, 70, 90, 128, None),
         (True, 200, 120, 32, -5), (True, 70, 90, 40, None)]


@pytest.mark.parametrize("causal,Tq,Tk,D,delta", CASES)
def test_split_backward_matches_pallas(causal, Tq, Tk, D, delta):
    q, k, v, do, o, lse, drows, scale = _inputs(0, 2, Tq, Tk, D, causal,
                                                delta)
    dq = emulated_dq(q, k, v, do, lse, drows, causal, scale, delta)
    dk, dv = emulated_dkv(q, k, v, do, lse, drows, causal, scale, delta)
    want = _pallas_backward(q, k, v, do, lse, drows, causal, scale, delta)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == w.shape and torch.isfinite(got).all()
        assert chip_smoke.rel_err(got, w)[0] <= GATE
    if causal and Tq > Tk and delta is None:
        assert not dq[:, :Tq - Tk].any()   # rows that see no key


def test_split_matches_the_ports_plain_version_at_long_causal_t():
    q, k, v, do, o, lse, drows, scale = _inputs(1, 2, 1024, 1024, 64,
                                                True)
    got = (emulated_dq(q, k, v, do, lse, drows, True, scale),
           *emulated_dkv(q, k, v, do, lse, drows, True, scale))
    want = tfa.flash_backward_reference(q, k, v, do, o, lse, True, scale)
    for g, w in zip(got, want):
        assert chip_smoke.rel_err(g, w)[0] <= GATE


def test_one_bf16_product_misses_the_gate():
    q, k, v, do, o, lse, drows, scale = _inputs(0, 2, 128, 128, 64, False)
    want = _pallas_backward(q, k, v, do, lse, drows, False, scale, None)
    dq = emulated_dq(q, k, v, do, lse, drows, False, scale, one=True)
    dk, dv = emulated_dkv(q, k, v, do, lse, drows, False, scale, one=True)
    for got, w in zip((dq, dk, dv), want):
        assert chip_smoke.rel_err(got, w)[0] > GATE


@contextlib.contextmanager
def _stub_card(monkeypatch):
    """The wrapper's card path with the C entry points replaced by
    recorders (returning 0): the calls it makes, in order."""
    calls = []

    def bind(name, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, args))
            return 0
        return fn
    monkeypatch.setattr(tfa, "on_card", lambda *t: True)
    monkeypatch.setattr(tfa._build, "bind", bind)
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for counter in ("DQ_LAUNCHES", "DKV_LAUNCHES"):
        monkeypatch.setattr(tfa, counter, getattr(tfa, counter))
    yield calls


def test_f32_backward_runs_on_copies_padded_along_d(monkeypatch):
    q, k, v, do, o, lse, _, scale = _inputs(3, 3, 70, 90, 42, True)
    with _stub_card(monkeypatch) as calls:
        before = (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
        dq, dk, dv = tfa.flash_backward(q, k, v, do, o, lse, True, scale)
    assert [c[0] for c in calls] == ["mxt_flash_attention_bwd_dq",
                                     "mxt_flash_attention_bwd_dkv"]
    (_, dq_args), (_, dkv_args) = calls
    assert dq_args[10] == 48 and dkv_args[11] == 48   # D, padded
    assert dq_args[14] == dkv_args[15] == 0            # f32
    assert all(p % 16 == 0 for p in dq_args[:7] + dkv_args[:8])
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert (tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)


def test_misaligned_f32_backward_inputs_raise(monkeypatch):
    from mxtpu_torch import MXNetError
    q, k, v, do, o, lse, _, scale = _inputs(4, 2, 64, 64, 32, False)
    buf = torch.zeros(q.numel() + 1)
    odd = buf[1:].view(q.shape)
    odd.copy_(q)
    with _stub_card(monkeypatch) as calls:
        with pytest.raises(MXNetError, match="16-byte"):
            tfa.flash_backward(odd, k, v, do, o, lse, False, scale)
    assert calls == []
