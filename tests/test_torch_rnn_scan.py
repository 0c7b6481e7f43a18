"""The persistent recurrence of the fused RNN op
(``mxtpu_torch/kernels/rnn_scan.py``, ``csrc/rnn_scan.cu``) on the CPU.

* The plain scan Functions (what the op runs on CPU tensors) against
  mxtpu's ``RNN`` op: outputs, final states and every input's gradient,
  LSTM and GRU, 1 and 2 layers, uni- and bidirectional; f32 at
  ``tests/test_torch_rnn.py``'s tolerances, bf16 (the port in bf16 on
  inputs rounded to bf16, mxtpu in f32 on the same values) at 2^-4 x
  max(1, |ref|): a bf16 rounding of h . W^T, h and c each step (2^-9
  relative) carried over T 5 steps and two layers, and gradients read
  as bf16 sums over T N rows.
* The Functions' backward decomposition (per-step cell backwards, one
  dW GEMM) against autograd through the plain forward, both directions.
* The kernel's partition, emulated in numpy: the forward's rows by unit
  (all G gate rows of a CTA's units), the backward's columns, at H 1500
  and 1003 over 132 CTAs, each (gate, unit) covered once and the plain
  step reproduced; a batch past 32 rows in chunks, each from its h0
  slot, reproducing the plain scan; the bf16 product's fragment
  addressing (two k16 products from one 16-byte load a lane, the same k
  permutation on A and B) against A B^T; the f32 product's register
  tiles and chunk walk covering each (row, batch column, 4 k) once, the
  staged weights exactly below KW.
* The plan: its ints in the order of the source's ``struct Plan``, its
  carve at the LM's width, the f32 tiles; ``scan_path``'s rule as a pure
  function of device, type and shape; the wrappers' refusals; the four
  launch counters.
"""
import numpy as np
import pytest
import torch

from mxtpu import autograd as jag
from mxtpu import nd as jnd

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tag
from mxtpu_torch import kernels
from mxtpu_torch import nd as tnd
from mxtpu_torch.kernels import rnn_cell as rc
from mxtpu_torch.kernels import rnn_scan as rs
from mxtpu_torch.ndarray.rnn_impl import rnn_param_size

torch.set_num_threads(2)
CPU = tmx.cpu()
FWD = {"rtol": 1e-5, "atol": 1e-6}
GRAD = {"rtol": 1e-4, "atol": 1e-4}
BF16_TOL = 2.0 ** -4
SMS = 132


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _run_op(pkg, ins, dtype=None, **kw):
    """The op's outputs and every input's gradient of sum(out^2)."""
    nd, ag = (jnd, jag) if pkg == "j" else (tnd, tag)
    arrs = [nd.array(a) if pkg == "j" else tnd.array(a, ctx=CPU)
            for a in ins]
    if dtype is not None:
        arrs = [a.astype(dtype) for a in arrs]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        outs = nd.RNN(*arrs, **kw)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        loss = sum((o.astype("float32") * o.astype("float32")).sum()
                   for o in outs)
    loss.backward()
    return ([o.astype("float32").asnumpy() for o in outs],
            [a.grad.astype("float32").asnumpy() for a in arrs])


def _no_cells(monkeypatch):
    """The per-step cell Functions raise: the op must not reach them."""
    def refuse(*a, **k):
        raise AssertionError("the per-step cell path ran")
    monkeypatch.setattr(rc, "lstm_cell", refuse)
    monkeypatch.setattr(rc, "gru_cell", refuse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
@pytest.mark.parametrize("layers,bi", [(1, False), (1, True), (2, False),
                                       (2, True)])
def test_plain_scan_matches_mxtpu(monkeypatch, dtype, mode, layers, bi):
    _no_cells(monkeypatch)
    T, N, I, H = 5, 3, 4, 6
    rng = np.random.RandomState(0)
    D = 2 if bi else 1
    P = rnn_param_size(layers, I, H, bi, mode)
    ins = [rng.randn(T, N, I).astype(np.float32),
           (rng.randn(P) * 0.3).astype(np.float32),
           rng.randn(layers * D, N, H).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.randn(layers * D, N, H).astype(np.float32))
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi,
              state_outputs=True)
    if dtype == "bfloat16":
        ins = [_bf16(a) for a in ins]
    jo, jg = _run_op("j", ins, **kw)
    to, tg = _run_op("t", ins, dtype=None if dtype == "float32" else dtype,
                     **kw)
    assert len(to) == len(jo) == (3 if mode == "lstm" else 2)
    if dtype == "float32":
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a, b, **FWD)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, **GRAD)
        return
    for a, b in zip(to + tg, jo + jg):
        err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
        assert err.max() <= BF16_TOL, err.max()


@pytest.mark.parametrize("mode", ["lstm", "gru"])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_backward_is_autograd_of_the_plain_forward(mode, reverse):
    """The Function's backward (per-step plain cell backwards, then one dW
    GEMM) against autograd through the plain forward's torch ops, f32;
    every gradient: pre, h0, c0, W_h2h, b_rn."""
    T, N, H = 6, 4, 5
    G = 4 if mode == "lstm" else 3
    rng = np.random.RandomState(7)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
    pre, h0, c0 = r(T, N, G * H), r(N, H), r(N, H)
    w, b = r(G * H, H, scale=0.4), r(H)
    dys, dh, dc = r(T, N, H), r(N, H), r(N, H)
    leaves = [t.clone().requires_grad_(True)
              for t in ((pre, h0, c0, w) if mode == "lstm"
                        else (pre, h0, w, b))]
    if mode == "lstm":
        ys, hT, cT = rs.lstm_scan(*leaves, reverse=reverse)
        got = torch.autograd.grad((ys, hT, cT), leaves, (dys, dh, dc))
        ref = [t.clone().requires_grad_(True) for t in (pre, h0, c0, w)]
        ys2, hT2, cT2, _, _ = rs.lstm_scan_fwd_reference(*ref, reverse)
        want = torch.autograd.grad((ys2, hT2, cT2), ref, (dys, dh, dc))
        outs = [(ys, ys2), (hT, hT2), (cT, cT2)]
    else:
        ys, hT = rs.gru_scan(*leaves, reverse=reverse)
        got = torch.autograd.grad((ys, hT), leaves, (dys, dh))
        ref = [t.clone().requires_grad_(True) for t in (pre, h0, w, b)]
        ys2, hT2, _ = rs.gru_scan_fwd_reference(*ref, reverse)
        want = torch.autograd.grad((ys2, hT2), ref, (dys, dh))
        outs = [(ys, ys2), (hT, hT2)]
    for a, b in outs:
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


# --------------------------------------------- the kernel's partition

@pytest.mark.parametrize("H", [1500, 1003])
def test_unit_slices_cover_every_gate_row_and_column_once(H):
    slices = rs.unit_slices(H, SMS)
    assert len(slices) == SMS
    assert {u for _, u in slices} == {H // SMS, -(-H // SMS)}
    for G in (4, 3):
        rows = np.zeros(G * H, np.int64)       # forward: W's rows
        cols = np.zeros(H, np.int64)           # backward: W's columns
        for j0, U in slices:
            for i in range(G * U):             # the kernel's row i
                rows[(i // U) * H + j0 + i % U] += 1
            cols[j0:j0 + U] += 1
        assert (rows == 1).all() and (cols == 1).all()


def _emulate_lstm_step(slices, pre, hprev, cprev, w):
    """One forward step CTA by CTA, as the kernel splits it: each CTA's
    G U rows of W against h, then the cell of its units."""
    N, GH = pre.shape
    H = GH // 4
    h, c = np.zeros((N, H), np.float32), np.zeros((N, H), np.float32)
    for j0, U in slices:
        idx = np.array([(i // U) * H + j0 + i % U for i in range(4 * U)])
        hh = hprev @ w[idx].T                  # (N, 4U): rows g U + u
        g4 = pre[:, idx] + hh

        def sig(x):
            return 1.0 / (1.0 + np.exp(-x))
        i_, f = sig(g4[:, :U]), sig(g4[:, U:2 * U])
        g, o = np.tanh(g4[:, 2 * U:3 * U]), sig(g4[:, 3 * U:])
        cc = f * cprev[:, j0:j0 + U] + i_ * g
        c[:, j0:j0 + U] = cc
        h[:, j0:j0 + U] = o * np.tanh(cc)
    return h, c


@pytest.mark.parametrize("H", [1500, 1003])
def test_partition_reproduces_the_plain_scan(H):
    """Two LSTM steps forward and the backward's dh_{t-1} = dhh . W by the
    kernel's split (CTA k's rows forward, its columns backward) against
    the plain scan, f32, 1e-5 x max(1, |plain|)."""
    T, N = 2, 3
    rng = np.random.RandomState(H)
    w = (rng.randn(4 * H, H) / np.sqrt(H)).astype(np.float32)
    pre = rng.randn(T, N, 4 * H).astype(np.float32)
    h0, c0 = rng.randn(N, H).astype(np.float32), \
        rng.randn(N, H).astype(np.float32)
    slices = rs.unit_slices(H, SMS)
    ys, hT, cT, gates, cs = rs.lstm_scan_fwd_reference(
        *(torch.from_numpy(a) for a in (pre, h0, c0, w)), False)
    h, c = h0, c0
    for t in range(T):
        h, c = _emulate_lstm_step(slices, pre[t], h, c, w)
        for a, b in ((h, ys[t]), (c, cs[t])):
            b = b.numpy()
            assert (np.abs(a - b) / np.maximum(1, np.abs(b))).max() <= 1e-5

    dhh = rng.randn(N, 4 * H).astype(np.float32)
    rec = np.zeros((N, H), np.float32)
    for j0, U in slices:
        rec[:, j0:j0 + U] = dhh @ w[:, j0:j0 + U]
    want = torch.matmul(torch.from_numpy(dhh), torch.from_numpy(w)).numpy()
    assert (np.abs(rec - want) / np.maximum(1, np.abs(want))).max() <= 1e-5


def test_mma_fragment_addressing_computes_a_times_b():
    """prod_bf16: lane (g, q) loads the 8 elements at k = 32 kb + 8 q of
    A rows g, g + 8 and of B row g; elements 0-3 make the first
    m16n8k16's fragments (a0, a2 / b0, b1 pairs), 4-7 the second's.
    Placed where mma.sync reads them (PTX's fragment layouts), the two
    products sum every k of the block once: the result is A B^T."""
    rng = np.random.RandomState(3)
    M, NB, KB = 32, 16, 96
    A, B = rng.randn(M, KB), rng.randn(NB, KB)
    out = np.zeros((M, NB))
    for kb in range(KB // 32):
        for mt in range(M // 16):
            for nt in range(NB // 8):
                for half in range(2):          # the two k16 products
                    Al, Bl = np.zeros((16, 16)), np.zeros((16, 8))
                    for lane in range(32):
                        g, q = lane >> 2, lane & 3
                        k0 = kb * 32 + q * 8 + 4 * half
                        ra = A[mt * 16 + g, k0:k0 + 4]
                        rb = A[mt * 16 + g + 8, k0:k0 + 4]
                        bb = B[nt * 8 + g, k0:k0 + 4]
                        # a0 = (row g, k 2q, 2q+1), a1 = (g + 8, same),
                        # a2 = (row g, k 2q+8, 2q+9), a3 = (g + 8, same)
                        Al[g, 2 * q:2 * q + 2] = ra[0:2]
                        Al[g + 8, 2 * q:2 * q + 2] = rb[0:2]
                        Al[g, 2 * q + 8:2 * q + 10] = ra[2:4]
                        Al[g + 8, 2 * q + 8:2 * q + 10] = rb[2:4]
                        # b0 = (k 2q, 2q+1; n g), b1 = (k 2q+8, 2q+9; n g)
                        Bl[2 * q:2 * q + 2, g] = bb[0:2]
                        Bl[2 * q + 8:2 * q + 10, g] = bb[2:4]
                    D = Al @ Bl
                    for lane in range(32):     # c0, c1 / c2, c3
                        g, q = lane >> 2, lane & 3
                        r0, c0 = mt * 16 + g, nt * 8 + 2 * q
                        out[r0, c0:c0 + 2] += D[g, 2 * q:2 * q + 2]
                        out[r0 + 8, c0:c0 + 2] += D[g + 8, 2 * q:2 * q + 2]
    np.testing.assert_allclose(out, A @ B.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("mode,H,N", [("lstm", 1500, 20), ("gru", 1500, 20),
                                      ("lstm", 1003, 7), ("gru", 1003, 7),
                                      ("lstm", 1003, 72), ("lstm", 8448, 3)])
def test_f32_product_split_covers_each_row_and_k_once(fwd, mode, H, N):
    """prod_f32: thread t (warp w, lane l) takes, in each pass of RP
    rows, rows rg + i RG (i < RL) and batch columns cg + j CG (j < CL),
    rest = l % (RG CG), rg = rest % RG, cg = rest / RG, and k phase w KSI
    + l / (RG CG) of KS = (TH / 32) KSI; over each chunk (at most KC
    columns, never straddling KW) it walks 4-k groups q = phase, phase +
    KS, ...  Every (row < R, column < NB, 4-k group) is summed by
    exactly one thread, from the staged weights exactly where k < KW;
    the lane's tile fits the compiled ones and the carve fits."""
    pl = rs.scan_plan(False, fwd, mode, N, H, SMS)
    assert pl is not None and pl["bytes"] <= rs.SMEM_MAX
    RG, CG, KSI, RL, CL, RP = (pl[f] for f in ("RG", "CG", "KSI", "RL",
                                                "CL", "RP"))
    KC, KB, KW, NB, TH = pl["KC"], pl["KB"], pl["KW"], pl["NB"], pl["TH"]
    assert RG * CG * KSI == 32 and RP == RG * RL and CL * CG == NB
    assert RL in rs.TILE_ROWS and CL in (6, 8) and TH % 32 == 0
    assert KW % 32 == 0 and KC % 32 == 0 and 0 <= KW <= KB
    assert pl["off_red"] == KW * pl["R"] * 4
    assert pl["off_out"] - pl["off_red"] >= max(
        TH // 32 * RP * NB * 4, 2 * pl["HALF"] * 4)
    assert pl["HALF"] >= NB * (KC + 4) + (KC * RP if KW < KB else 0)
    chunks, k0 = [], 0
    while k0 < KB:
        k1 = min(k0 + KC, KW if k0 < KW else KB)
        chunks.append((k0, k1))
        k0 = k1
    KS = TH // 32 * KSI
    G = 4 if mode == "lstm" else 3
    for U in sorted({u for _, u in rs.unit_slices(H, SMS)}):
        R = (G if fwd else 1) * U
        seen = np.zeros((R, NB, KB // 4), np.int64)
        for t in range(TH):
            w, lane = divmod(t, 32)
            rest = lane % (RG * CG)
            rg, cg = rest % RG, rest // RG
            phase = w * KSI + lane // (RG * CG)
            for r0 in range(0, R, RP):
                rows = [r0 + rg + i * RG for i in range(RL)]
                cols = [cg + j * CG for j in range(CL)]
                for k0, k1 in chunks:
                    for q in range(phase, (k1 - k0) // 4, KS):
                        for row in rows:
                            if row < R:
                                seen[row, cols, k0 // 4 + q] += 1
        assert (seen == 1).all()


def test_f32_weights_stage_what_fits():
    """The f32 plans at the LM's width: the chunk takes KC_F32's widest
    that fits; the weights' first KW columns stay in shared memory where
    the chunk buffers leave room (backward 2432 of 6016 and of 4512;
    forward the 384-column buffers leave none); at the ragged H 1003 all
    of them but the LSTM forward's (832 of 1024); ``kw=0`` stages
    none."""
    want = {("lstm", True): (0, 832), ("gru", True): (32, 1024),
            ("lstm", False): (2432, 4032), ("gru", False): (2432, 3040)}
    for (mode, fwd), (kw, ragged) in want.items():
        p = rs.scan_plan(False, fwd, mode, 20, 1500, SMS)
        assert (p["KC"], p["KW"], p["TH"]) == (384, kw, rs.F32_THREADS)
        assert rs.scan_plan(False, fwd, mode, 7, 1003, SMS)["KW"] == ragged
        p0 = rs.scan_plan(False, fwd, mode, 20, 1500, SMS, kw=0)
        assert p0["KW"] == 0 and p0["off_red"] == 0


@pytest.mark.parametrize("R,nb,want", [(48, 24, (8, 4, 1, 6, 6)),
                                       (36, 24, (8, 4, 1, 6, 6)),
                                       (12, 24, (2, 4, 4, 6, 6)),
                                       (32, 8, (4, 1, 8, 8, 8)),
                                       (8, 8, (1, 1, 32, 8, 8)),
                                       (4, 8, (1, 1, 32, 4, 8)),
                                       (252, 24, (8, 4, 1, 8, 6))])
def test_f32_tiles_favour_loads_per_fma(R, nb, want):
    """The lane tile (RG, CG, KSI, RL, CL): at the LM's forward 48 rows x
    24 columns a lane holds 6 x 6 (12 loads for 144 FMAs), one k phase a
    warp; the backward's 12 rows 6 x 6 with 4 phases a warp; past 64
    rows at nb 24 the rows run in passes of 64."""
    assert rs.f32_tiles(R, nb) == want


@pytest.mark.parametrize("n,chunks,cn,nb", [(1, 1, 1, 8), (20, 1, 20, 24),
                                            (32, 1, 32, 32), (33, 2, 17, 24),
                                            (40, 2, 20, 24), (64, 2, 32, 32),
                                            (72, 3, 24, 24),
                                            (200, 7, 29, 32)])
def test_batch_runs_in_chunks_of_at_most_32_rows(n, chunks, cn, nb):
    """The batch runs in ceil(n / 32) chunks of CN rows (the last one
    shorter), each padded to NB; the forward's exchange holds the ring's
    two slots, then each chunk's h0 zero-padded."""
    for bf in (False, True):
        for fwd in (True, False):
            p = rs.scan_plan(bf, fwd, "lstm", n, 1003, SMS)
            assert (p["CN"], p["NB"]) == (cn, nb)
            assert -(-n // p["CN"]) == chunks
    H = 37
    h0 = torch.randn(n, H)
    slots = rs._exchange(p, torch.float32, "cpu", h0)
    assert tuple(slots.shape) == (2 + chunks, nb, p["KB"])
    assert not slots[:2].any()
    for c in range(chunks):
        rows = h0[c * cn:(c + 1) * cn]
        assert torch.equal(slots[2 + c, :rows.shape[0], :H], rows)
        assert not slots[2 + c, rows.shape[0]:].any()
        assert not slots[2 + c, :, H:].any()


def test_batch_chunks_reproduce_the_plain_scan():
    """The forward as the kernel runs a batch past 32 rows: chunk by
    chunk, each from its h0 slot and its own c, every step over the
    CTAs' unit slices; against the plain scan of the whole batch, f32,
    1e-5 x max(1, |plain|)."""
    T, N, H, P = 3, 40, 37, 5
    rng = np.random.RandomState(N)
    w = (rng.randn(4 * H, H) / np.sqrt(H)).astype(np.float32)
    pre = rng.randn(T, N, 4 * H).astype(np.float32)
    h0, c0 = rng.randn(N, H).astype(np.float32), \
        rng.randn(N, H).astype(np.float32)
    plan = rs.scan_plan(False, True, "lstm", N, H, P)
    slots = rs._exchange(plan, torch.float32, "cpu",
                         torch.from_numpy(h0)).numpy()
    ys, hT, cT, _, _ = rs.lstm_scan_fwd_reference(
        *(torch.from_numpy(a) for a in (pre, h0, c0, w)), False)
    CN, slices = plan["CN"], rs.unit_slices(H, P)
    for c, n0 in enumerate(range(0, N, CN)):
        nc = min(CN, N - n0)
        h, cc = slots[2 + c, :nc, :H], c0[n0:n0 + nc]
        for t in range(T):
            h, cc = _emulate_lstm_step(slices, pre[t, n0:n0 + nc], h, cc, w)
            b = ys[t, n0:n0 + nc].numpy()
            assert (np.abs(h - b) / np.maximum(1, np.abs(b))).max() <= 1e-5
        b = cT[n0:n0 + nc].numpy()
        assert (np.abs(cc - b) / np.maximum(1, np.abs(b))).max() <= 1e-5


def test_plan_fields_are_the_kernels_plan_struct():
    """The plan reaches the kernel as ints in ``PLAN_FIELDS``' order:
    the fields of ``struct Plan`` in ``csrc/rnn_scan.cu``, one for one."""
    import pathlib
    import re
    src = (pathlib.Path(rs.__file__).parents[1] / "csrc" /
           "rnn_scan.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\b([A-Za-z_]\w*)\s*[,;]", body)
    assert tuple(fields) == rs.PLAN_FIELDS
    assert "int " in body and "float" not in body


# ------------------------------------------------------------ the path

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cpu_tensors_always_take_the_plain_scan(dtype):
    for n, H in ((20, 1500), (40, 1500), (7, 4096)):
        for mode in ("lstm", "gru"):
            assert rs.scan_path("cpu", dtype, n, H, mode, SMS) == "plain"


@pytest.mark.parametrize("mode,dtype,n,H,want", [
    ("lstm", torch.float32, 20, 1500, "scan"),     # the LM
    ("lstm", torch.bfloat16, 20, 1500, "scan"),    # TrainStep's LM
    ("gru", torch.float32, 20, 1500, "scan"),
    ("gru", torch.bfloat16, 20, 1500, "scan"),
    ("lstm", torch.float32, 7, 1003, "scan"),      # ragged
    ("gru", torch.bfloat16, 7, 1003, "scan"),
    ("lstm", torch.float32, 1, 1, "scan"),
    ("lstm", torch.float32, 32, 1500, "scan"),
    ("lstm", torch.float32, 33, 1500, "scan"),     # N past 32: chunks
    ("gru", torch.bfloat16, 40, 1500, "scan"),
    ("lstm", torch.float32, 200, 1500, "scan"),
    ("lstm", torch.bfloat16, 20, 2048, "cell"),    # bf16 W past shared
    ("gru", torch.bfloat16, 20, 2048, "cell"),
    ("lstm", torch.bfloat16, 24, 1632, "scan"),    # bf16 W in shared
    ("lstm", torch.bfloat16, 24, 1633, "cell"),
    ("lstm", torch.bfloat16, 32, 1584, "scan"),
    ("lstm", torch.bfloat16, 32, 1585, "cell"),
    ("gru", torch.bfloat16, 20, 1980, "scan"),
    ("gru", torch.bfloat16, 20, 1981, "cell"),
    ("lstm", torch.float32, 20, 16896, "scan"),    # f32: row passes
    ("lstm", torch.float32, 20, 43560, "scan"),    # f32: the carve
    ("lstm", torch.float32, 20, 43561, "cell"),
    ("lstm", torch.float64, 20, 1500, "cell"),     # the cells refuse it
    ("lstm", torch.float16, 20, 1500, "cell"),
])
def test_scan_path_on_the_card(mode, dtype, n, H, want):
    assert rs.scan_path("cuda", dtype, n, H, mode, SMS) == want


def test_scan_plan_is_the_launch_arithmetic():
    """The LM's plans: bf16 keeps the 48 rows x 1504 of W in shared
    memory forward and 12 x 6048 backward; f32 a lane a 6 x 6 tile, 384
    threads, 384-column chunks double-buffered in the partial sums'
    space, the weights' first KW columns before them."""
    p = rs.scan_plan(True, True, "lstm", 20, 1500, SMS)
    assert (p["R"], p["RP"], p["KST"], p["NB"], p["TH"]) == \
        (48, 48, 1504, 24, 256)
    assert p["bytes"] == 48 * 1504 * 2 + 8 * 48 * 24 * 4 + 48 * 24 * 4 + \
        12 * 24 * 4
    p = rs.scan_plan(True, False, "lstm", 20, 1500, SMS)
    assert (p["R"], p["KB"], p["KST"]) == (12, 6016, 6048)
    p = rs.scan_plan(False, True, "lstm", 20, 1500, SMS)
    assert (p["RP"], p["KC"], p["KW"], p["HALF"]) == \
        (48, 384, 0, 24 * 388 + 384 * 48)
    assert p["bytes"] == 2 * p["HALF"] * 4 + 48 * 24 * 4 + 12 * 24 * 4
    p = rs.scan_plan(False, False, "lstm", 20, 1500, SMS)
    assert (p["RP"], p["KC"], p["KW"]) == (12, 384, 2432)
    assert p["bytes"] == 2432 * 12 * 4 + 2 * p["HALF"] * 4 + \
        12 * 24 * 4 + 2 * 12 * 24 * 4
    for bf in (True, False):
        for fwd in (True, False):
            for mode in ("lstm", "gru"):
                assert rs.scan_plan(bf, fwd, mode, 20, 1500, SMS)["bytes"] \
                    <= rs.SMEM_MAX


def test_scan_wrappers_refuse_what_the_kernel_cannot_take():
    with pytest.raises(tmx.MXNetError, match="f32 or bf16"):
        rs._check("lstm_scan_fwd", torch.float64, 8, 2,
                  torch.zeros(8, 2, dtype=torch.float64))
    with pytest.raises(tmx.MXNetError, match="w_h2h"):
        rs._check("lstm_scan_fwd", torch.float32, 8, 2, torch.zeros(8, 3))
    with pytest.raises(tmx.MXNetError, match="mixed types"):
        rs._check("lstm_scan_fwd", torch.float32, 8, 2, torch.zeros(8, 2),
                  torch.zeros(3, dtype=torch.bfloat16))
    with pytest.raises(tmx.MXNetError, match="contiguous"):
        rs._check("lstm_scan_fwd", torch.float32, 8, 2, torch.zeros(8, 2),
                  torch.zeros(4, 3).t())


def test_scan_counters_in_launch_counts():
    """The four counters sit in kernels.launch_counts(), reset with the
    rest, and a CPU scan counts nothing."""
    names = ("lstm_scan_fwd", "lstm_scan_bwd", "gru_scan_fwd",
             "gru_scan_bwd")
    rs.LSTM_SCAN_FWD_LAUNCHES = 3
    assert kernels.launch_counts()["lstm_scan_fwd"] == 3
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    assert all(counts[n] == 0 for n in names)
    pre = torch.randn(3, 2, 8, requires_grad=True)
    ys, hT, cT = rs.lstm_scan(pre, torch.zeros(2, 2), torch.zeros(2, 2),
                              torch.randn(8, 2))
    (ys.sum() + hT.sum()).backward()
    ys, hT = rs.gru_scan(pre[..., :6], torch.zeros(2, 2), torch.randn(6, 2),
                         torch.randn(2))
    ys.sum().backward()
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("mode,H", [("lstm", 37), ("gru", 23), ("lstm", 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_feed_the_product(fwd, mode, H, dtype):
    """CTA k's block of ``_pack``: f32 [KB / 4][R][4] as prod_f32 reads
    it (row i's 4-k group q at ((q R) + i) 4), bf16 [R][KB] as stage_w
    copies it.  Summed against the state block by block, the packed
    weights give h . W^T (forward) and dhh . W (backward) for every
    CTA's units; past K and past a CTA's rows they are zero."""
    P, N = 5, 3
    G = 4 if mode == "lstm" else 3
    rng = np.random.RandomState(H)
    w = torch.from_numpy(rng.randn(G * H, H).astype(np.float32)).to(dtype)
    pk = rs._pack(w, G, fwd, H, P).float()
    w = w.float()
    K = H if fwd else G * H
    KB = -(-K // 32) * 32
    R = (G if fwd else 1) * -(-H // P)
    if dtype == torch.bfloat16:
        assert tuple(pk.shape) == (P, R, KB)
        pk = pk.view(P, R, KB // 4, 4).transpose(1, 2)
    assert tuple(pk.shape) == (P, KB // 4, R, 4)
    b = torch.from_numpy(rng.randn(N, KB).astype(np.float32))
    b[:, K:] = 0
    want = b[:, :K] @ (w.t() if fwd else w)          # (N, G H) or (N, H)
    for k, (j0, U) in enumerate(rs.unit_slices(H, P)):
        a = pk[k].permute(1, 0, 2).reshape(R, KB)      # row i, k
        got = b @ a.t()                                # (N, R)
        for i in range(R):
            if i >= (G if fwd else 1) * U:
                assert not a[i].any()
                continue
            col = (i // U) * H + j0 + i % U
            np.testing.assert_allclose(got[:, i].numpy(),
                                       want[:, col].numpy(), rtol=1e-5,
                                       atol=1e-5)
        assert not a[:, K:].any()
