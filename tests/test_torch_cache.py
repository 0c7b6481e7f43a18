"""The port's persistent compile cache (``mxtpu_torch/cache.py``) against
``tests/test_cache.py``'s scenarios and, where both packages have the
part, against mxtpu on the same inputs.

* The cache core: key composition (any flipped component misses,
  identical keys hit across processes), crash-safe concurrent writes,
  the verify-or-quarantine loader against every scripted poisoning
  (corrupt, truncated, stale, an mxtpu entry in a port root) — a
  poisoned entry is never unpickled — and the read-only degradation.
* The kernel entries of ``kernels/_build.py``, through a stub ``nvcc``
  (a script that copies a shared library), since there is no ``nvcc``
  here.
* The runners: a fresh ``ModelRunner`` warms its ladder from disk with
  no cold build and serves the cold runner's rows bit for bit; int8
  entries stay apart from their float twin; ``GenerateRunner`` keys by
  its KV table's geometry.
* Against mxtpu: the key components both caches compose, the runners'
  fingerprints of one export, and the fleet-kill, poisoned-replacement
  and autoscaler scenarios of ``test_cache.py:407-590`` under one fake
  clock.  mxtpu's side runs in a subprocess on one XLA CPU device: a
  loaded XLA:CPU executable expects as many shards as the process has
  devices, and the tests' process has eight.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import mxtpu_torch
from mxtpu_torch import cache as tcache
from mxtpu_torch.cache import (CacheKey, ExecutableCache, default_cache,
                               poison_corrupt, self_check)
from mxtpu_torch.kernels import _build
from mxtpu_torch.serving import (CorruptEntry, FaultPlan, GenerateRunner,
                                 ModelRunner, ReadOnlyDir, StaleKey,
                                 TruncateEntry)
from mxtpu_torch import symbol as tsym

from tests.torch_fleet_helpers import (PKGS, FakeClock, crank,
                                       fleet_record, mul_runner, payload)

REPO = Path(__file__).resolve().parents[1]


def _program():
    """A tiny picklable program and its input."""
    return (tcache._Affine(np.full(8, 2.0, np.float32),
                           np.ones(8, np.float32)),
            torch.arange(8, dtype=torch.float32))


def _key(cache, **kw):
    kw.setdefault("shape", "(8,)f32")
    return cache.key(device="cpu", **kw)


# ----------------------------------------------------- key composition

def test_cache_key_digest_is_order_independent_and_flip_sensitive():
    a = CacheKey({"model": "m", "shape": "(4,)", "mesh": "1dev"})
    b = CacheKey({"mesh": "1dev", "shape": "(4,)", "model": "m"})
    assert a.digest == b.digest and a.filename() == b.filename()
    for comp, val in (("model", "m2"), ("shape", "(8,)"),
                      ("mesh", "2dev")):
        assert a.replace(**{comp: val}).digest != a.digest


@pytest.mark.parametrize("comp, val", [
    ("contract", "feedfeedfeedfeed"), ("mesh", "4dev"), ("torch", "0.0.0"),
    ("cuda", "0.0"), ("backend", "cuda"), ("device", "NVIDIA H100"),
    ("kernels", "feedfeedfeedfeed"), ("shape", "(16,)f32"),
    ("model", "fp1"), ("salt", "rolled"), ("format", "0")])
def test_flipping_any_key_component_misses_on_disk(tmp_path, comp, val):
    cache = ExecutableCache(tmp_path)
    program, _ = _program()
    key = _key(cache, model="fp0")
    assert comp in key.components
    assert cache.store(key, program)
    assert cache.load(key.replace(**{comp: val})) is None
    st = cache.stats()
    assert st["quarantined"] == 0 and st["miss"] == 1
    assert cache.load(key) is not None       # the entry is intact


def test_key_components_shared_with_mxtpu(tmp_path):
    """The components both caches compose agree: what was built, the
    mesh, the backend and device on the CPU, the contracts' hash, the
    salt and the format."""
    from mxtpu.cache import ExecutableCache as JCache
    jkey = JCache(tmp_path / "j", salt="s").key(
        model="m", shape="(8,)f32", mesh="1dev", device="cpu")
    tkey = ExecutableCache(tmp_path / "t", salt="s").key(
        model="m", shape="(8,)f32", mesh="1dev", device="cpu")
    shared = set(jkey.components) & set(tkey.components)
    assert shared == {"model", "shape", "mesh", "backend", "device",
                      "contract", "salt", "format"}
    assert {k: jkey.components[k] for k in shared} == \
        {k: tkey.components[k] for k in shared}
    # the port's own: torch and CUDA in place of jax, the kernel sources
    assert set(tkey.components) - shared == {"torch", "cuda", "kernels"}


# ------------------------------------------------------ round trips

def test_round_trip_executes_identically(tmp_path):
    cache = ExecutableCache(tmp_path)
    program, x = _program()
    key = _key(cache, model="rt")
    got, source = cache.load_or_compile(key, lambda: program)
    assert source == "cold" and got is program and cache.entries() == 1
    got2, source2 = cache.load_or_compile(
        key, lambda: pytest.fail("hit path must not build"))
    assert source2 == "disk"
    assert torch.equal(got2(x), program(x))


def test_store_meta_round_trips(tmp_path):
    cache = ExecutableCache(tmp_path)
    program, _ = _program()
    key = _key(cache, model="meta")
    assert cache.store(key, program, meta={"build_seconds": 1.5})
    loaded, meta = cache.load(key, with_meta=True)
    assert loaded is not None and meta == {"build_seconds": 1.5}
    missed, meta2 = cache.load(key.replace(model="nope"), with_meta=True)
    assert missed is None and meta2 == {}
    assert cache.store(key, program, meta={"build_seconds": 0.0})
    assert cache.load(key, with_meta=True)[1] == {"build_seconds": 0.0}


def test_identical_keys_across_two_processes_hit(tmp_path):
    """A second process composes the same key, and its entry hits here."""
    child = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from mxtpu_torch.cache import ExecutableCache, _Affine
import numpy as np
cache = ExecutableCache({str(tmp_path)!r})
key = cache.key(model="xproc", shape="(8,)f32", device="cpu")
prog = _Affine(np.full(8, 2.0, np.float32), np.ones(8, np.float32))
assert cache.store(key, prog), "child store failed"
print(key.digest)
"""
    out = subprocess.run([sys.executable, "-c", child],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cache = ExecutableCache(tmp_path)
    key = _key(cache, model="xproc")
    assert key.digest == out.stdout.strip().splitlines()[-1]
    loaded = cache.load(key)
    program, x = _program()
    assert loaded is not None and torch.equal(loaded(x), program(x))


def test_concurrent_writers_race_cleanly(tmp_path):
    """Writers hammer one key from separate cache instances while a
    reader polls: it sees nothing or a valid entry, never a torn one."""
    program, x = _program()
    want = program(x)
    caches = [ExecutableCache(tmp_path) for _ in range(4)]
    key = _key(caches[0], model="race")
    start = threading.Barrier(5)
    failures = []

    def writer(c):
        start.wait()
        for _ in range(5):
            if not c.store(key, program):
                failures.append("store refused")

    def reader():
        rc = ExecutableCache(tmp_path)
        start.wait()
        for _ in range(20):
            got = rc.load(key)
            if got is not None and not torch.equal(got(x), want):
                failures.append("torn/wrong entry served")
        if rc.stats()["quarantined"]:
            failures.append("reader quarantined a mid-write entry")

    threads = [threading.Thread(target=writer, args=(c,), daemon=True)
               for c in caches] + [threading.Thread(target=reader,
                                                    daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not failures, failures
    assert not any(t.is_alive() for t in threads)
    assert torch.equal(ExecutableCache(tmp_path).load(key)(x), want)
    assert not list(Path(tmp_path).glob("*.tmp"))


# ----------------------------------------------- scripted cache faults

@pytest.fixture
def unpickled(monkeypatch):
    """The payloads ``pickle.loads`` was handed during the test."""
    seen = []
    real = pickle.loads

    def spy(data, *a, **kw):
        seen.append(bytes(data))
        return real(data, *a, **kw)

    monkeypatch.setattr(pickle, "loads", spy)
    return seen


@pytest.mark.parametrize("fault_cls,reason", [
    (CorruptEntry, "checksum"),
    (TruncateEntry, "truncated"),
    (StaleKey, "stale_key"),
])
def test_poisoned_entry_quarantines_never_executes(tmp_path, fault_cls,
                                                   reason, unpickled):
    plan = FaultPlan(fault_cls(at_store=0))
    cache = ExecutableCache(tmp_path, faults=plan)
    program, x = _program()
    key = _key(cache, model="poison")
    assert cache.store(key, program)         # the fault poisons post-commit
    assert plan.fired == [f"{fault_cls.__name__.lower()}@0"]
    assert cache.load(key) is None and unpickled == []
    st = cache.stats()
    assert st["quarantined"] == 1 and st["hit"] == 0
    qfiles = list((Path(tmp_path) / "quarantine").iterdir())
    assert len(qfiles) == 1 and f".{reason}." in qfiles[0].name
    got, source = cache.load_or_compile(key, lambda: program)
    assert source == "cold"
    got2, source2 = cache.load_or_compile(
        key, lambda: pytest.fail("recovered entry must hit"))
    assert source2 == "disk" and torch.equal(got2(x), program(x))


def test_mxtpu_entry_in_a_port_root_is_quarantined(tmp_path, unpickled):
    """An entry mxtpu's cache wrote, renamed into a port root under a
    port key: the port's magic differs, so it is quarantined as
    "magic" and never unpickled."""
    import jax
    import jax.numpy as jnp
    from mxtpu.cache import ExecutableCache as JCache
    jcache = JCache(tmp_path / "j")
    x = jnp.arange(8, dtype=jnp.float32)
    compiled = jax.jit(lambda v: v * 2 + 1).lower(x).compile()  # mxlint: disable=hlo-raw-assert (building a Compiled to cache, not inspecting HLO)
    jkey = jcache.key(model="m", shape="(8,)f32")
    assert jcache.store(jkey, compiled)
    cache = ExecutableCache(tmp_path / "t")
    key = _key(cache, model="m")
    cache.root.mkdir()
    shutil.copy(jcache.path_for(jkey), cache.path_for(key))
    assert cache.load(key) is None and unpickled == []
    (q,) = (cache.root / "quarantine").iterdir()
    assert ".magic." in q.name


def test_read_only_dir_falls_back_without_error(tmp_path):
    from mxtpu_torch import obs
    plan = FaultPlan(ReadOnlyDir(from_store=0))
    cache = ExecutableCache(tmp_path, faults=plan)
    program, _ = _program()
    key = _key(cache, model="ro")
    got, source = cache.load_or_compile(key, lambda: program)
    assert source == "cold" and got is program
    assert plan.fired == ["readonlydir@0"] and not cache.writable()
    st = cache.stats()
    assert st["fallback"] == 1 and cache.entries() == 0
    if obs.enabled():
        assert "fallback" in [e["kind"] for e in cache.recorder.events()]
    assert not cache.store(key, program)     # latched: no second fire
    assert plan.fired == ["readonlydir@0"]


def test_cache_self_check_passes(tmp_path):
    info = self_check(root=str(tmp_path / "sc"))
    assert info["serialize_supported"] and info["round_trip"]
    assert info["poisons"] == 4 and info["read_only_fallback"]


def test_default_cache_is_knob_driven(tmp_path, monkeypatch):
    monkeypatch.delenv("MXTPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("MXTPU_CACHE", raising=False)
    monkeypatch.delenv("MXTPU_CACHE_SALT", raising=False)
    assert default_cache() is None
    monkeypatch.setenv("MXTPU_CACHE_DIR", str(tmp_path))
    c1 = default_cache()
    assert c1 is not None and c1.root == Path(tmp_path)
    assert default_cache() is c1
    monkeypatch.setenv("MXTPU_CACHE_SALT", "v2")
    c2 = default_cache()
    assert c2 is not c1 and c2.salt == "v2"
    monkeypatch.setenv("MXTPU_CACHE", "0")
    assert default_cache() is None


# ---------------------------------------------------- kernel entries

@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A fresh build state, an ``nvcc`` that copies a shared library to
    its ``-o`` and logs each build, and ``MXTPU_CACHE_DIR`` at a root:
    returns (root, the build log's path)."""
    import _ctypes
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "nvcc: NVIDIA (R) Cuda compiler"
  echo "Cuda compilation tools, release 12.9, V12.9.41"
  exit 0
fi
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
cp {_ctypes.__file__} "$out"
echo build >> {log}
echo "ptxas info    : stub"
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    root = tmp_path / "root"
    monkeypatch.setenv("MXTPU_CACHE_DIR", str(root))
    monkeypatch.delenv("MXTPU_CACHE", raising=False)

    def fresh():        # the state a new process starts from
        for name in ("_libs", "build_seconds", "build_log",
                     "build_source", "_entry_digests"):
            monkeypatch.setattr(_build, name, {})
        monkeypatch.setattr(_build, "_nvcc_release", None)

    fresh()
    return root, log, fresh


def _builds(log):
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_kernel_entry_round_trips(stub_nvcc):
    root, log, fresh = stub_nvcc
    _build.build_all(("layer_norm", "nms"))
    assert _build.build_source == {"layer_norm": "nvcc", "nms": "nvcc"}
    assert _builds(log) == 2 and default_cache().entries() == 2
    assert "stub" in _build.ptxas_log("layer_norm")
    digests = _build.kernel_entries()
    fresh()
    _build.build_all(("layer_norm", "nms"))
    assert _build.build_source == {"layer_norm": "disk", "nms": "disk"}
    assert _builds(log) == 2                 # no nvcc
    assert _build.kernel_entries() == digests
    assert "stub" in _build.ptxas_log("layer_norm")
    assert hasattr(_build.load("layer_norm"), "PyInit__ctypes")
    key = _build._entry_key(default_cache(), "layer_norm")
    assert key.components["nvcc"] == \
        "Cuda compilation tools, release 12.9, V12.9.41"
    assert key.components["flags"] == " ".join(_build.NVCC_FLAGS)


def test_corrupt_kernel_entry_is_quarantined_and_rebuilt(stub_nvcc,
                                                         unpickled):
    root, log, fresh = stub_nvcc
    _build.build_all(("layer_norm",))
    path = default_cache().path_for(
        _build._entry_key(default_cache(), "layer_norm"))
    poison_corrupt(path)
    fresh()
    _build.build_all(("layer_norm",))
    assert _build.build_source == {"layer_norm": "nvcc"}
    assert _builds(log) == 2 and unpickled == []
    (q,) = (root / "quarantine").iterdir()
    assert ".checksum." in q.name
    fresh()                                  # the rebuild was stored
    _build.build_all(("layer_norm",))
    assert _build.build_source == {"layer_norm": "disk"}


# ------------------------------------------------ serving integration

def _mul(cache):
    return ModelRunner(tsym.var("data") * tsym.var("w"),
                       {"w": np.array([1.0, 2.0, 3.0], np.float32)},
                       {"data": (3,)}, max_batch_size=4, device="cpu",
                       cache=cache)


@pytest.fixture(scope="module")
def bert_export(tmp_path_factory):
    """A 2-layer BERT exported by mxtpu (the export both packages
    load)."""
    from mxtpu import nd as jnd
    from mxtpu.models.transformer import BERTModel as JBERT
    from tests.torch_gluon_names import fresh_names
    with fresh_names():
        net = JBERT(64, 32, 64, 2, 2, max_length=32, dropout=0.0)
    net.initialize(init="xavier")
    net(jnd.array(np.zeros((1, 8), np.float32)))
    return net.export(str(tmp_path_factory.mktemp("bert") / "bert"))


BERT_SPEC = dict(input_specs={"data": (None,)}, seq_buckets=[8, 16],
                 max_batch_size=2)


def test_runner_warms_full_ladder_from_disk_zero_compiles(tmp_path,
                                                          bert_export):
    donor = ModelRunner.from_export(*bert_export, device="cpu",
                                    cache=ExecutableCache(tmp_path),
                                    **BERT_SPEC)
    donor.warmup()
    n = donor.num_compiled()
    assert n == len(donor.buckets()) == 4 and donor.cold_compiles() == n
    rng = np.random.RandomState(3)
    rows = {"data": rng.randint(0, 64, (2, 13)).astype(np.float32)}
    want = donor.infer(rows)
    fresh = ExecutableCache(tmp_path)
    runner = ModelRunner.from_export(*bert_export, device="cpu",
                                     cache=fresh, **BERT_SPEC)
    assert sorted(runner.cached_buckets()) == sorted(runner.buckets())
    assert set(runner.warm_from_disk()) == set(runner.buckets())
    st = fresh.stats()
    assert st["hit"] == n and st["store"] == 0
    assert runner.cold_compiles() == 0
    assert set(runner.compile_sources().values()) == {"disk"}
    for got, w in zip(runner.infer(rows), want):
        np.testing.assert_array_equal(got, w)
    assert runner.num_compiled() == n


def test_recipe_mismatch_quarantines_as_stale_and_builds_cold(tmp_path):
    """A verified recipe whose build launches other kernels (here: one
    edited by hand) is quarantined as stale_key, the bucket counts
    cold and is stored again."""
    writer = _mul(ExecutableCache(tmp_path))
    writer.warmup([(1, None)])
    cache = ExecutableCache(tmp_path)
    key = writer._cache_key((1, None))
    recipe = cache.load(key)
    assert recipe["outputs"] == [[[1, 3], "float32"]]
    recipe["launches"] = {"layer_norm_fwd": 1}
    assert cache.store(key, recipe)
    reader = _mul(ExecutableCache(tmp_path))
    reader.warmup([(1, None)])
    assert reader.compile_sources() == {(1, None): "cold"}
    st = reader._cache.stats()
    assert st["quarantined"] == 1 and st["store"] == 1
    (q,) = (Path(tmp_path) / "quarantine").iterdir()
    assert ".stale_key." in q.name
    again = _mul(ExecutableCache(tmp_path))
    again.warmup([(1, None)])
    assert again.compile_sources() == {(1, None): "disk"}


def test_fingerprints_match_mxtpu_on_one_export(tmp_path, bert_export):
    """One export loaded by both packages: the canonical graph and the
    whole model fingerprint (graph, input specs, parameter signatures,
    donation, pad value) agree."""
    from mxtpu.cache import ExecutableCache as JCache
    from mxtpu.serving import ModelRunner as JRunner
    from mxtpu_torch.serving.runner import canonical_graph
    j = JRunner.from_export(*bert_export, cache=JCache(tmp_path / "j"),
                            **BERT_SPEC)
    t = ModelRunner.from_export(*bert_export, device="cpu",
                                cache=ExecutableCache(tmp_path / "t"),
                                **BERT_SPEC)
    graph = canonical_graph(t._symbol)
    assert graph == canonical_graph(j._symbol)
    assert all(n["name"].startswith("_op") for n in graph["nodes"]
               if n["op"] != "null")
    assert t._fingerprint == j._fingerprint


def _fc_quant_runner(cache, quant=False, scale=1.0):
    out = tsym.FullyConnected(tsym.var("data"), tsym.var("w"),
                              tsym.var("b"), num_hidden=4)
    rng = np.random.RandomState(7)
    r = ModelRunner(out, {"w": rng.randn(4, 6).astype(np.float32),
                          "b": np.zeros(4, np.float32)},
                    {"data": (6,)}, max_batch_size=2, cache=cache,
                    quant=quant or None, device="cpu")
    if quant:
        r.calibrate([{"data": scale * np.linspace(
            -1.0, 1.0, 12, dtype=np.float32).reshape(2, 6)}],
            mode="minmax")
    return r


def test_quantized_entries_isolated_from_float_twin(tmp_path):
    fl = _fc_quant_runner(ExecutableCache(tmp_path))
    fl.warmup()
    n = fl.num_compiled()
    assert n == len(fl.buckets()) >= 2
    q1 = _fc_quant_runner(ExecutableCache(tmp_path), quant=True)
    bucket = fl.buckets()[0]
    assert q1._cache_key(bucket).digest != fl._cache_key(bucket).digest
    assert q1._cache_key(bucket).components["quant"] == "int8"
    assert q1.cached_buckets() == []
    q1.warmup()
    assert q1._cache.stats()["hit"] == 0 and \
        q1._cache.stats()["store"] == n
    fresh = _fc_quant_runner(ExecutableCache(tmp_path))
    assert sorted(fresh.cached_buckets()) == sorted(fresh.buckets())
    q2 = _fc_quant_runner(ExecutableCache(tmp_path), quant=True)
    assert sorted(q2.cached_buckets()) == sorted(q2.buckets())
    q2.warm_from_disk()
    assert q2._cache.stats()["hit"] == n and q2.cold_compiles() == 0
    q3 = _fc_quant_runner(ExecutableCache(tmp_path), quant=True,
                          scale=5.0)
    assert q3.cached_buckets() == []         # recalibrated: all miss


def test_quantized_poisoned_entry_quarantines_and_recompiles(tmp_path):
    plan = FaultPlan(CorruptEntry(at_store=0))
    q1 = _fc_quant_runner(ExecutableCache(tmp_path, faults=plan),
                          quant=True)
    q1.warmup()
    n = q1.num_compiled()
    assert n >= 2 and plan.fired == ["corruptentry@0"]
    fresh = ExecutableCache(tmp_path)
    q2 = _fc_quant_runner(fresh, quant=True)
    assert sorted(q2.cached_buckets()) == sorted(q2.buckets())
    q2.warm_from_disk()
    st = fresh.stats()
    assert st["quarantined"] == 1 and st["hit"] == n - 1
    assert st["store"] == 1 and q2.cold_compiles() == 1
    assert q2.num_compiled() == n


@pytest.fixture(scope="module")
def gen_export(tmp_path_factory):
    from mxtpu_torch import cpu, nd
    from mxtpu_torch.models import BERTModel
    from tests.torch_gluon_names import fresh_names
    with fresh_names():
        net = BERTModel(32, 16, 32, 2, 2, max_length=16, dropout=0.0,
                        use_token_type=False, causal=True)
    net.initialize(ctx=cpu())
    net(nd.array(np.ones((1, 3), np.float32), ctx=cpu()),
        nd.zeros((1,), ctx=cpu()), nd.zeros(net.kv_cache_spec(1), ctx=cpu()))
    return net, net.export(str(tmp_path_factory.mktemp("gen") / "g"))


def test_generate_cache_keys_include_kv_geometry(tmp_path, gen_export):
    """The KV table's geometry is in the fingerprint (lanes and capacity
    each split it), so is donation, and mxtpu's GenerateRunner over the
    same export fingerprints alike; a second runner warms from disk."""
    from mxtpu.cache import ExecutableCache as JCache
    from mxtpu.serving import GenerateRunner as JGen
    net, files = gen_export

    def runner(lanes=1, cap=16, **kw):
        return GenerateRunner.from_export(
            *files, net.kv_cache_spec(lanes, cap), prompt_buckets=(4,),
            device="cpu", cache=ExecutableCache(tmp_path), **kw)

    base = runner()
    fps = {base._fingerprint, runner(lanes=2)._fingerprint,
           runner(cap=8)._fingerprint, runner(donate=False)._fingerprint}
    assert len(fps) == 4
    keys = {runner()._cache_key(b).digest for b in base.buckets()}
    assert len(keys) == len(base.buckets())
    assert runner()._cache_key(("decode", (2,))).components["shape"] == \
        "gen:decode:(2,)"
    j = JGen.from_export(*files, net.kv_cache_spec(1, 16),
                         prompt_buckets=(4,), cache=JCache(tmp_path / "j"))
    assert j._fingerprint == base._fingerprint
    base.warmup()
    again = runner()
    assert sorted(again.cached_buckets()) == sorted(again.buckets())
    again.warm_from_disk()
    assert set(again.compile_sources().values()) == {"disk"}
    kv = again.new_cache()
    toks = np.array([[1, 2, 3, 0]], np.float32)
    args = (toks, np.zeros(1, np.float32), np.zeros(1, np.float32))
    np.testing.assert_array_equal(again.prefill(*args, kv)[0],
                                  base.prefill(*args, base.new_cache())[0])


# ------------------------------------ the fleet scenarios against mxtpu

def _worker(P, clk, name, cache):
    return P.FleetWorker(mul_runner(P, cache=cache), name, clock=clk,
                         max_queue_delay_us=0.0)


def _router(P, clk):
    return P.FleetRouter(clock=clk, threaded=False, canary=None)


def _kinds(rec):
    return [e["kind"] for e in rec.events()]


def sc_fleet_kill_then_disk_warmed_replacement(P, C, root):
    clk = FakeClock()
    seed = C.ExecutableCache(root)
    with _router(P, clk) as router:
        w0 = _worker(P, clk, "w0", seed)
        router.add_worker(w0)
        w0.runner.warmup()
        nbuckets = w0.runner.num_compiled()
        router.kill("w0")
        fresh = C.ExecutableCache(root)
        w1 = _worker(P, clk, "w1", fresh)
        warmed = router.add_worker(w1)
        compiled = w1.runner.num_compiled()
        stats = fresh.stats()
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(6)]
        crank(router, clk, n=4)
        return {"warmed": warmed, "nbuckets": nbuckets,
                "compiled": compiled, "stats": stats,
                "after": w1.runner.num_compiled(),
                "fleet": fleet_record(router, reqs),
                "cache_events": _kinds(P.obs.flight("cache")),
                "compile_events": _kinds(P.obs.flight("compile"))}


def sc_fleet_replacement_with_poisoned_cache(P, C, root):
    clk = FakeClock()
    seed = C.ExecutableCache(root)
    with _router(P, clk) as router:
        w0 = _worker(P, clk, "w0", seed)
        router.add_worker(w0)
        w0.runner.warmup()
        router.kill("w0")
        for entry in sorted(Path(root).glob("*.mxc")):
            C.poison_corrupt(entry)
        fresh = C.ExecutableCache(root)
        w1 = _worker(P, clk, "w1", fresh)
        warmed = router.add_worker(w1)
        stats = fresh.stats()
        quarantined = sorted(p.name.split(".")[2] for p in
                             (Path(root) / "quarantine").iterdir())
        req = router.submit(payload(5), timeout_s=10.0)
        crank(router, clk, n=2)
        return {"warmed": warmed, "stats": stats,
                "quarantined": quarantined,
                "compiled": w1.runner.num_compiled(),
                "fleet": fleet_record(router, [req]),
                "cache_events": _kinds(P.obs.flight("cache"))}


def sc_autoscaler_scale_up_warms_from_disk(P, C, root):
    clk = FakeClock()
    seed = C.ExecutableCache(root)
    r = _router(P, clk)
    w0 = _worker(P, clk, "w0", seed)
    r.add_worker(w0)
    w0.runner.warmup()
    made = []

    def make_worker(name):
        w = _worker(P, clk, name, C.ExecutableCache(root))
        made.append(w)
        return w

    scaler = P.Autoscaler(r, make_worker, min_workers=1, max_workers=2,
                          up_depth=3.0, down_depth=0.5, breach_ticks=2,
                          cooldown_s=0.1)
    r.add_controller(scaler.tick)
    r.kill("w0")
    reqs = [r.submit(payload(i), timeout_s=30.0) for i in range(6)]
    for _ in range(20):
        clk.advance(0.05)
        r.tick(clk())
        if made:
            break
    crank(r, clk, n=6)
    out = {"made": [w.name for w in made],
           "compiled": [w.runner.num_compiled() for w in made],
           "scaler": [{k: e[k] for k in ("kind", "worker", "donor")
                       if k in e} for e in scaler.recorder.events()],
           "fleet": fleet_record(r, reqs)}
    r.close()
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_fleet_kill_then_disk_warmed_replacement,
    sc_fleet_replacement_with_poisoned_cache,
    sc_autoscaler_scale_up_warms_from_disk)}


def records(pkg, tmp):
    """Every scenario's record on ``pkg``, through JSON (what the
    subprocess hands back)."""
    P = PKGS[pkg]
    C = tcache if pkg == "port" else __import__("mxtpu.cache").cache
    out = {}
    for name, sc in SCENARIOS.items():
        P.obs.reset()
        out[name] = sc(P, C, str(Path(tmp) / pkg / name))
    return json.loads(json.dumps(out, default=repr))


@pytest.fixture(scope="module")
def mxtpu_records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jfleet")
    child = (f"import json, sys; sys.path.insert(0, {str(REPO)!r}); "
             f"from tests.test_torch_cache import records; "
             f"print(json.dumps(records('mxtpu', {str(tmp)!r})))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    out = subprocess.run([sys.executable, "-c", child], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_cache_scenario_matches_mxtpu(name, mxtpu_records, tmp_path):
    port = records("port", tmp_path)[name]
    assert port == mxtpu_records[name]
    if name == "fleet_kill_then_disk_warmed_replacement":
        assert port["warmed"] == "disk_cache"
        assert port["compiled"] == port["nbuckets"] == port["after"]
        assert port["stats"]["hit"] == port["nbuckets"]
        assert port["stats"]["store"] == 0
    elif name == "fleet_replacement_with_poisoned_cache":
        n = port["compiled"]
        assert port["stats"]["quarantined"] == n == port["stats"]["store"]
        assert port["stats"]["hit"] == 0
        assert port["quarantined"] == ["checksum"] * n
    else:
        ups = [e for e in port["scaler"] if e["kind"] == "scale_up"]
        assert ups and ups[0]["donor"] == "disk_cache"
        assert port["compiled"] == [3]


def test_port_runner_rejects_foreign_cache_objects():
    with pytest.raises(TypeError, match="ExecutableCache"):
        _mul(object())
    from mxtpu.cache import ExecutableCache as JCache
    with pytest.raises(TypeError, match="ExecutableCache"):
        _mul(JCache("/nonexistent"))
    assert mxtpu_torch.cache.ExecutableCache is ExecutableCache
