"""mxtpu_torch kernels (plain PyTorch paths on the CPU) held against the
mxtpu Pallas kernels run in interpreter mode and against their lax
references.

The same inputs, made from a numpy seed, go to both packages.  f32
tolerances: 1e-5 (LayerNorm, epilogue: one f32 reduction order apart),
2e-5 (attention: two f32 products and an exp apart).  The dropout mask
is integer arithmetic and must match bit for bit.  The CUDA kernels
themselves run only on the card, through ``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu_torch import MXNetError, kernels as tk

# by module path: both kernel packages re-export functions of the
# modules' own names
tfa_mod = importlib.import_module("mxtpu_torch.kernels.flash_attention")
tln_mod = importlib.import_module("mxtpu_torch.kernels.layer_norm")
jfa_mod = importlib.import_module("mxtpu.kernels.flash_attention")
jln_mod = importlib.import_module("mxtpu.kernels.layer_norm")

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # mxtpu's Pallas kernels run in interpreter mode on the CPU
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")


def _qkv(seed, B, H, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32))


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("causal,Tq,Tk", [
    (False, 32, 32), (True, 32, 32),      # the plain self-attention case
    (False, 13, 13), (True, 13, 13),      # odd T (mxtpu pads and masks)
    (False, 8, 24), (True, 8, 24),        # Tq < Tk: diagonal offset
    (True, 24, 8),                        # Tq > Tk: fully masked rows
])
def test_flash_attention_matches_mxtpu(causal, Tq, Tk):
    q, k, v = _qkv(0, 2, 2, Tq, Tk, 16)
    got = tk.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal).numpy()
    pallas = np.asarray(jfa_mod.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    ref = np.asarray(jfa_mod.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("causal,Tq,Tk", [(False, 16, 16), (True, 16, 32),
                                          (True, 32, 8)])
def test_flash_forward_lse_matches_pallas(causal, Tq, Tk):
    q, k, v = _qkv(1, 1, 3, Tq, Tk, 8)
    q3, k3, v3 = (a.reshape(3, -1, 8) for a in (q, k, v))
    o, lse = tfa_mod.flash_forward(torch.from_numpy(q3),
                                   torch.from_numpy(k3),
                                   torch.from_numpy(v3), causal, 0.25)
    jo, jlse = jfa_mod._flash_forward(jnp.asarray(q3), jnp.asarray(k3),
                                      jnp.asarray(v3), causal, 0.25, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    # fully masked rows carry the +1e30 sentinel on both sides
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=1e-5, atol=1e-5)


def test_attention_bf16_plain_close_to_f32():
    q, k, v = _qkv(2, 1, 2, 16, 16, 16)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    f32 = tk.flash_attention(*t).numpy()
    bf = tk.flash_attention(*[a.bfloat16() for a in t])
    assert bf.dtype == torch.bfloat16
    # bf16 keeps ~3 significant digits; outputs are O(1)
    np.testing.assert_allclose(bf.float().numpy(), f32, atol=3e-2)


# ------------------------------------------------------------ LayerNorm

@pytest.mark.parametrize("shape", [(32, 64), (3, 7, 48)])
def test_layer_norm_matches_mxtpu(shape):
    rng = np.random.RandomState(3)
    C = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    got = tk.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b)).numpy()
    pallas = np.asarray(jln_mod.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(b)))
    ref = np.asarray(jln_mod.layer_norm_reference(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_layer_norm_stats_match_pallas_kernel():
    rng = np.random.RandomState(4)
    x = rng.randn(16, 32).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    y, mean, rstd = tln_mod.layer_norm_fwd(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    jy, jmean, jrstd = jln_mod._pallas_ln_fwd(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                               rtol=1e-5)


# ------------------------------------------------- fused residual epilogue

def test_threefry_known_answer_vectors():
    # Random123 known-answer vectors, as mxtpu's own test pins them
    def tf(k0, k1, x0, x1):
        y0, y1 = tln_mod._threefry2x32(k0, k1, torch.tensor([x0]),
                                       torch.tensor([x1]))
        return int(y0), int(y1)
    assert tf(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert tf(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3) == \
        (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("k0,k1,row0", [(123, 456, 0),
                                        (0xDEADBEEF, 7, 5),
                                        (0xFFFFFFFF, 0xFFFFFFFF, 1)])
def test_mask_bits_bit_exact(k0, k1, row0):
    got = tln_mod.mask_bits(k0, k1, row0, 6, 40).numpy()
    want = np.asarray(jln_mod._mask_bits(jnp.uint32(k0), jnp.uint32(k1),
                                         jnp.uint32(row0), 6, 40))
    assert np.array_equal(got.astype(np.uint32), want)
    assert tln_mod.keep_thresh(0.9) == jln_mod._keep_thresh(0.9)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_epilogue_matches_mxtpu(p):
    rng = np.random.RandomState(5)
    shape, C = (2, 12, 64), 64
    h, res = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    bias, b = (rng.randn(C).astype(np.float32) for _ in range(2))
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    key = np.array([123, 456], np.uint32)
    got = tk.fused_residual_layer_norm(
        *(torch.from_numpy(a) for a in (h, bias, res, g, b)), key,
        p=p).numpy()
    j = [jnp.asarray(a) for a in (h, bias, res, g, b)]
    pallas = np.asarray(jln_mod.fused_residual_layer_norm(
        *j, jnp.asarray(key), p=p))
    ref = np.asarray(jln_mod.fused_residual_ln_reference(
        *j, jnp.asarray(key), p=p))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if p:
        # the parity above exercised the mask: some elements dropped
        bits = np.asarray(jln_mod._mask_bits(
            jnp.uint32(123), jnp.uint32(456), jnp.uint32(0), 24, C))
        dropped = (bits >= jln_mod._keep_thresh(1 - p)).reshape(shape)
        assert 0 < dropped.sum() < dropped.size


def test_fused_epilogue_eval_ignores_key_and_p():
    rng = np.random.RandomState(6)
    h, bias, res, g, b = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                          for s in ((4, 32), (32,), (4, 32), (32,), (32,)))
    y_eval = tk.fused_residual_layer_norm(h, bias, res, g, b, None, p=0.5,
                                          training=False)
    y_p0 = tk.fused_residual_layer_norm(h, bias, res, g, b, None, p=0.0)
    assert torch.equal(y_eval, y_p0)
    with pytest.raises(MXNetError, match="two uint32 words"):
        tk.fused_residual_layer_norm(h, bias, res, g, b, [1, 2, 3], p=0.1)


# --------------------------------------------------------- dispatch rule

def test_cpu_tensors_take_plain_path_and_count_nothing():
    tk.reset_launch_counts()
    x = torch.randn(4, 16, requires_grad=True)
    tk.layer_norm(x, torch.ones(16), torch.zeros(16)).sum().backward()
    qkv = [torch.randn(1, 2, 8, 4, requires_grad=True) for _ in range(3)]
    tk.flash_attention(*qkv).sum().backward()
    tk.fused_residual_layer_norm(x, torch.zeros(16), x, torch.ones(16),
                                 torch.zeros(16), [1, 2]).sum().backward()
    xb = torch.randn(2, 16, 3, 3, requires_grad=True)
    tk.fused_bn_act(xb, torch.ones(16), torch.zeros(16), act="relu",
                    residual=xb)[0].sum().backward()
    tk.fused_bn_act(x, torch.ones(16), torch.zeros(16))[0].sum().backward()
    tk.conv_nhwc(torch.randn(1, 3, 3, 8), torch.randn(3, 3, 8, 8))
    rc = importlib.import_module("mxtpu_torch.kernels.rnn_cell")
    pre = torch.randn(2, 12, requires_grad=True)
    sum(rc.lstm_cell(pre, torch.randn(2, 12), torch.randn(2, 3))) \
        .sum().backward()
    rc.gru_cell(pre[:, :9], torch.randn(2, 9), torch.randn(3),
                torch.randn(2, 3)).sum().backward()
    assert pre.grad is not None
    moe = importlib.import_module("mxtpu_torch.kernels.moe")
    logits = torch.randn(6, 3, requires_grad=True)
    xm = torch.randn(6, 4, requires_grad=True)
    gate_p, mean_p, sot, tos, _ = moe.route_tokens(logits, 2)
    ein = moe.dispatch_tokens(xm, tos, sot)
    (moe.combine_tokens(ein * 2.0, sot, tos, gate_p).sum() +
     mean_p.sum()).backward()
    assert logits.grad is not None and xm.grad is not None
    assert x.grad is not None and qkv[0].grad is not None
    assert xb.grad is not None
    assert tk.launch_counts() == {"flash_attention_fwd": 0,
                                  "flash_attention_bwd_dq": 0,
                                  "flash_attention_bwd_dkv": 0,
                                  "layer_norm_fwd": 0,
                                  "layer_norm_bwd": 0,
                                  "fused_residual_ln_fwd": 0,
                                  "fused_residual_ln_bwd": 0,
                                  "batch_norm_fwd": 0,
                                  "batch_norm_bwd": 0,
                                  "batch_norm_fwd_cm": 0,
                                  "batch_norm_bwd_cm": 0,
                                  "conv_nhwc": 0,
                                  "nms": 0,
                                  "lstm_cell_fwd": 0,
                                  "lstm_cell_bwd": 0,
                                  "gru_cell_fwd": 0,
                                  "gru_cell_bwd": 0,
                                  "lstm_scan_fwd": 0,
                                  "lstm_scan_bwd": 0,
                                  "gru_scan_fwd": 0,
                                  "gru_scan_bwd": 0,
                                  "moe_route": 0,
                                  "moe_dispatch": 0,
                                  "moe_dispatch_bwd": 0,
                                  "moe_combine": 0,
                                  "moe_combine_bwd": 0}


def test_dispatch_refuses_devices_it_has_no_path_for():
    with pytest.raises(MXNetError, match="unsupported device"):
        tk.on_card(torch.empty(2, device="meta"))
    with pytest.raises(MXNetError, match="several devices"):
        tk.on_card(torch.empty(2), torch.empty(2, device="meta"))
