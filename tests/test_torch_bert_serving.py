"""A small BERT exported by mxtpu, served by mxtpu_torch on the CPU
from the export (``ModelRunner.from_export``: the ``-symbol.json``
graph and the ``.params`` file) and held against mxtpu's own serving
path.

The weights cross in the legacy ``.params`` format written by
``HybridBlock.export``.  Logits agree within 1e-4 (f32 on both sides:
the same products in another summation order, over two encoder
layers).  Also here: the weight carry-over into a Block and its
failure modes, the ``.params`` reader, device resolution, and the rule
that the port imports neither jax nor mxtpu.  Both packages build
their BERT with fresh name counters, so the port's Block carries the
exported names (``bertmodel0_pos_embed``, ...) and the weights cross
by name.
"""
import ast
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mxtpu import nd
from mxtpu.c_predict import _params_from_bytes
from mxtpu.models.transformer import BERTModel as JBERT
from mxtpu.ndarray import legacy_format as j_legacy
from mxtpu.serving import InferenceServer as JServer
from mxtpu.serving import ModelRunner as JRunner

from mxtpu_torch import MXNetError, autograd, cpu
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.ndarray import legacy_format, load_params
from mxtpu_torch.models import BERTModel
from mxtpu_torch.serving import InferenceServer, ModelRunner, batch_ladder

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
V, U, H, L, MAXLEN = 128, 64, 4, 2, 40
SPEC = dict(input_specs={"data": (None,)}, seq_buckets=[16, 32],
            max_batch_size=4)
ATOL = 1e-4


def _torch_bert(initialize=False):
    """The port's BERT, named as a fresh process names it; with
    ``initialize``, its own random weights on the CPU (the deferred
    shapes filled by one forward)."""
    with fresh_names():
        net = BERTModel(V, U, 4 * U, L, H, max_length=MAXLEN,
                        dropout=0.1)
    if initialize:
        net.initialize(ctx=cpu())
        net(torch.zeros(1, 8))
    return net


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """mxtpu BERT (dropout on, so inference must switch it off) written
    by ``export``; returns (symbol file, params file)."""
    with fresh_names():
        net = JBERT(V, U, 4 * U, L, H, max_length=MAXLEN, dropout=0.1)
    net.initialize(init="xavier")
    net(nd.array(np.zeros((1, 8), np.float32)))
    return net.export(str(tmp_path_factory.mktemp("bert") / "bert"))


@pytest.fixture(scope="module")
def runners(exported):
    sym_file, params_file = exported
    jr = JRunner.from_export(sym_file, params_file, cache=None, **SPEC)
    tr = ModelRunner.from_export(sym_file, params_file, device="cpu",
                                 **SPEC)
    return jr, tr


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, V, shape) \
        .astype(np.float32)


# -------------------------------------------------------------- weights

def test_load_params_matches_c_predict_order_and_values(exported):
    _, params_file = exported
    got = load_params(params_file)
    with open(params_file, "rb") as f:
        want = _params_from_bytes(f.read())
    assert list(got) == list(want)
    assert list(got)[0].endswith("pos_embed")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_legacy_format_copy_writes_mxtpu_bytes():
    rng = np.random.RandomState(0)
    payload = {"a": rng.randn(3, 4).astype(np.float32),
               "b": np.arange(5, dtype=np.int32)}
    blob = legacy_format.dumps(payload)
    assert blob == j_legacy.dumps(payload)
    arrays, names = legacy_format.loads(blob)
    assert names == ["a", "b"]
    np.testing.assert_array_equal(arrays[0], payload["a"])


def test_params_from_mxtpu_order_matches_collect_params(exported):
    _, params_file = exported
    params = load_params(params_file)
    net = params_from_mxtpu(params, _torch_bert())
    assert list(net.collect_params()) == list(params)
    named = list(net.named_parameters())
    assert [n for n, _ in named[:3]] == ["pos_embed", "word_embed.weight",
                                         "type_embed.weight"]
    for (_, p), a in zip(named, params.values()):
        np.testing.assert_array_equal(p.detach().numpy(), a)


def test_params_from_mxtpu_raises_on_shape_mismatch(exported):
    params = load_params(exported[1])
    bad = dict(params)
    k = next(k for k in bad if k.endswith("_weight") and
             bad[k].shape == (3 * U, U))
    bad[k] = np.zeros((3 * U, U + 1), np.float32)
    # the shapes are known once a forward has run (before it, Dense's
    # in_units is 0 and takes whatever the file holds, as in mxtpu)
    with pytest.raises(MXNetError, match="has shape"):
        params_from_mxtpu(bad, _torch_bert(initialize=True))


def test_params_from_mxtpu_raises_on_count_mismatch(exported):
    params = load_params(exported[1])
    params.popitem()
    # a Block matches by name: the missing array is a missing name
    with pytest.raises(MXNetError, match="missing"):
        params_from_mxtpu(params, _torch_bert())


# --------------------------------------------------------------- runner

@pytest.mark.parametrize("n,T", [(3, 12), (4, 32), (1, 17)])
def test_runner_infer_matches_mxtpu(runners, n, T):
    jr, tr = runners
    toks = _tokens(n * 100 + T, n, T)
    (want,) = jr.infer({"data": toks})
    (got,) = tr.infer({"data": toks})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


def test_servers_agree_on_mixed_length_requests(runners):
    jr, tr = runners
    rng = np.random.RandomState(7)
    lens = [int(x) for x in rng.randint(3, 33, 12)]
    reqs = [_tokens(100 + i, n) for i, n in enumerate(lens)]
    results = {}
    for name, server, runner in (("jax", JServer(), jr),
                                 ("torch", InferenceServer(), tr)):
        with server:
            server.register("bert", runner, max_queue_delay_us=5000)
            outs = [None] * len(reqs)

            def client(idx):
                for i in idx:
                    outs[i] = server.submit(
                        "bert", {"data": reqs[i]}).result(timeout=60)[0]

            threads = [threading.Thread(target=client,
                                        args=(range(c, len(reqs), 3),))
                       for c in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        snap = server.stats("bert")
        assert snap["completed"] == len(reqs)
        assert snap["extras"].get("requeues", 0) == 0
        results[name] = outs
    for n, got, want in zip(lens, results["torch"], results["jax"]):
        assert got.shape == (n, V)
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


def test_bucket_ladder_and_padding_rules(runners):
    _, tr = runners
    assert batch_ladder(6) == (1, 2, 4, 6)
    assert tr.bucket_for(3, 17) == (4, 32)
    assert tr.seq_bucket_for(16) == 16
    with pytest.raises(MXNetError, match="exceeds largest bucket"):
        tr.bucket_for(1, 33)
    (vals,) = tr._pad_stack([{"data": np.arange(3, dtype=np.float32)},
                             {"data": np.arange(5, dtype=np.float32)}],
                            (4, 16))
    assert vals.shape == (4, 16)
    # sequence pad = pad_value (0); batch pad repeats row 0
    assert vals[0, 3:].abs().sum() == 0
    assert torch.equal(vals[2], vals[0]) and torch.equal(vals[3], vals[0])


def test_float_token_ids_truncate_like_mxtpu(runners):
    jr, tr = runners
    toks = _tokens(3, 2, 10) + 0.75       # 5.75 embeds as id 5
    (want,) = jr.infer({"data": toks})
    (got,) = tr.infer({"data": toks})
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


def test_serving_knob_sets_the_ladder(exported, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING_MAX_BATCH", "6")
    r = ModelRunner.from_export(*exported, device="cpu",
                                input_specs={"data": (None,)},
                                seq_buckets=[8])
    assert r.batch_buckets == (1, 2, 4, 6)


def test_training_mode_draws_seeded_dropout_and_serving_runs_eval(
        tmp_path):
    # a training forward drops out from the seeded generators, and
    # serving never sees it: ModelRunner runs its export outside
    # training mode (autograd.is_training(), the flag the graph's
    # Dropout and fused epilogues read), where dropout is off
    from mxtpu_torch import random as trandom
    net = _torch_bert(initialize=True)          # dropout 0.1
    toks = torch.from_numpy(_tokens(4, 2, 16))  # fills a bucket
    with autograd.train_mode():
        trandom.seed(5)
        a = net(toks)
        trandom.seed(5)
        b = net(toks)
        c = net(toks)
    assert torch.equal(a, b) and not torch.equal(b, c)
    runner = ModelRunner.from_export(*net.export(str(tmp_path / "bert")),
                                     device="cpu", **SPEC)
    (served,) = runner.infer({"data": toks.numpy()})
    (again,) = runner.infer({"data": toks.numpy()})
    np.testing.assert_array_equal(served, again)
    np.testing.assert_allclose(served, net(toks).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(served, a.detach().numpy(), atol=1e-3)


# --------------------------------------------------- devices and imports

def test_default_device_is_the_card(exported):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would be cuda:0")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        ModelRunner.from_export(*exported, input_specs={"data": (None,)},
                                seq_buckets=[8])


def test_port_imports_neither_jax_nor_mxtpu():
    files = sorted((REPO / "mxtpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "mxtpu")]
    assert not bad, bad


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
