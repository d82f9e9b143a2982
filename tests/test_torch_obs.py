"""The port's device telemetry and observability tools against the JAX
reference's ScopeKit (``repro.obs``), on the CPU, on the same numpy inputs.

Contract:

* every counter is an exact integer equal to the reference's: ``unary`` in
  ``table_ref``, ``table_pack_ref`` and ``quant_pack_ref`` (out-of-domain
  hits, lookups, quant saturation and gathers; also ``sharded_pack_ref``
  and ``folded_pack_ref``, whose folded members count only non-finite
  inputs) over a linspace and each member's edges, ``routed_fn`` called
  twice (dispatch rows), flash
  attention's ``count_mask`` over KV_PAD lanes beside a genuine empty slot
  (shared and per-slot key positions), a ContinuousEngine serve of the
  mixed-EOS queue (the whole counter dict) and one remat'd training step
  (each checkpointed layer counted again in its recompute, as the
  reference's ``jax.checkpoint`` does);
* with telemetry on, the tokens equal the telemetry-off run's; off (the
  default) and enabled after the build, nothing is recorded, the closures
  are the un-wrapped ones and ``attn_exp()`` is the cached object itself;
* ``compile_counts()`` (build counts) equals the reference's jit cache sizes
  on the serving tests' queue, and flipping obs on changes neither;
* ``span_stats`` / ``render_summary`` / ``diff_summaries`` /
  ``merge_summaries`` give the reference's output on the same trace dicts;
* both CLIs' ``--obs --trace`` write a trace that ``validate_trace`` accepts,
  with the reference's counter names.

Inputs are normal floats, zeros and non-finite values: XLA on the CPU
flushes subnormals to zero, PyTorch does not.  The reference's seed-0 init
and the served queue are shared by module fixtures (the init and the jit
compiles are most of the file's time).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.approx import ApproxConfig as JApprox
from repro.models import attention as j_attention
from repro.models import build_model as j_build_model
from repro.obs.metrics import merge_summaries as j_merge_summaries
from repro.obs.report import diff_summaries as j_diff
from repro.obs.report import render_summary as j_render
from repro.obs.report import span_stats as j_span_stats
from repro.optim import adamw as j_adamw
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import DecodeEngine as JDecodeEngine
from repro.serving.engine import serve_static as j_serve_static
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import obs
from repro_torch.approx import ApproxConfig
from repro_torch.approx import activations as t_act
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import attention as t_attention
from repro_torch.models import build_model, reduced
from repro_torch.obs.metrics import merge_summaries
from repro_torch.obs.report import diff_summaries, render_summary, span_stats
from repro_torch.optim import adamw
from repro_torch.serving.engine import ContinuousEngine, DecodeEngine, serve_static
from repro_torch.train.loop import batch_to, make_train_step
from tests.test_archs import reduced as j_reduced
from tests.test_serving import mixed_requests

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from check_trace import validate_trace  # noqa: E402

# the reference's telemetry tests' budget, for every case: one pack a
# package and mode for the whole file
EA = 1e-3


def _clean():
    for o in (obs, jobs):
        o.disable()
        o.reset_tracer()
        o.reset_registry()


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with both ScopeKits fully off and empty."""
    _clean()
    yield
    _clean()


def _telemetry_on():
    for o in (obs, jobs):
        o.configure(enabled=True, device_telemetry=True)


def _counters():
    """(port, reference) global counter dicts, after the reference's
    callbacks have all run."""
    jax.effects_barrier()
    return (obs.get_registry().summary()["counters"],
            jobs.get_registry().summary()["counters"])


# --------------------------------------------------------------------------------------
# unary and routed closures
# --------------------------------------------------------------------------------------


def _edges(cfg: ApproxConfig, name: str) -> np.ndarray:
    """The member's domain ends, their f32 neighbours, and the non-finite
    and zero inputs."""
    if cfg.mode in t_act.FOLDED_MODES:  # the whole f32 range: its far ends
        lo, hi = -3.0e38, 3.0e38
    elif cfg.mode == "table_ref":
        b = cfg.table_for(name, "cpu").boundaries
        lo, hi = float(b[0]), float(b[-1])
    else:
        reg = t_act._TABLE_NAME.get(name, name)
        lo, hi = t_act.member_domain(cfg._pack_for_mode("cpu"), reg)
    ends = np.asarray([lo, hi, -lo, -hi], np.float32)
    x = np.concatenate([
        ends, np.nextafter(ends, np.float32(np.inf)),
        np.nextafter(ends, np.float32(-np.inf)),
        np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e30], np.float32)])
    # a zero end's neighbours are subnormal
    return x[~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))]


UNARY_CASES = [(m, f) for m in ("table_ref", "table_pack_ref", "quant_pack_ref")
               for f in ("tanh", "gelu", "exp")] + [("sharded_pack_ref", "tanh"),
                                                    ("folded_pack_ref", "exp")]


@pytest.mark.parametrize("mode,fn", UNARY_CASES + [("routed_pack_ref", "routed")],
                         ids=[f"{m}-{f}" for m, f in UNARY_CASES] + ["routed"])
def test_counters_match_reference(mode, fn):
    _telemetry_on()
    tcfg, jcfg = ApproxConfig(mode=mode, e_a=EA), JApprox(mode=mode, e_a=EA)
    if fn == "routed":
        names = ["gelu", "tanh", "gelu"]
        x = np.random.default_rng(0).normal(0, 4, (3, 8)).astype(np.float32)
        tf, jf = tcfg.routed_fn(names, "cpu"), jax.jit(jcfg.routed_fn(names))
        calls = 2
    else:
        x = np.concatenate([np.linspace(-16, 16, 64, dtype=np.float32),
                            _edges(tcfg, fn)])
        tf, jf = tcfg.unary(fn, "cpu"), jax.jit(jcfg.unary(fn))
        calls = 1
    for _ in range(calls):
        tf(torch.from_numpy(x))
        jf(jnp.asarray(x))
    got, want = _counters()
    assert got == want
    assert all(type(v) is int for v in got.values())
    if fn == "routed":
        assert got == {"approx.routed.gelu": 4, "approx.routed.tanh": 2}
    else:
        reg = "exp_neg" if fn == "exp" and "folded" not in mode else fn
        assert got[f"approx.lookups.{reg}"] == x.size
        assert 0 < got[f"approx.oob.{reg}"] < x.size
        if mode == "quant_pack_ref":
            assert got[f"approx.quant_gathers.{reg}"] == 2 * x.size


def test_off_by_default_and_enable_after_build_record_nothing():
    """The build-time contract: a closure built with telemetry off is the
    un-wrapped one, records nothing, and stays so when the flag flips."""
    x = torch.linspace(-4, 4, 32)
    for mode in ("quant_pack_ref", "table_pack_ref"):
        cfg = ApproxConfig(mode=mode, e_a=EA, attn_table=True)
        f, g, e = cfg.unary("tanh", "cpu"), cfg.routed_fn(["gelu", "silu"], "cpu"), \
            cfg.attn_exp("cpu")
        assert not hasattr(f, "wants_count_mask")
        assert e is next(v for k, v in t_act._ATTN_EXP_CACHE.items()
                         if k[0] == mode and k[1] == EA)
        obs.configure(enabled=True, device_telemetry=True)
        f(x), g(x.reshape(2, 16)), e(-x.abs())
        assert obs.get_registry().summary()["counters"] == {}
        # built now, the closures are wrapped; the cache keeps the bare one
        assert cfg.attn_exp("cpu") is not e
        assert cfg.attn_exp("cpu").wants_count_mask
        assert cfg.attn_exp("cpu") is not cfg.attn_exp("cpu")
        obs.disable()
        assert cfg.attn_exp("cpu") is e


def test_counter_feeds_device_sums_without_reading_them():
    reg = obs.Registry()
    c = reg.counter("n")
    c.add(3)
    c.add(torch.tensor(4))
    c.add((torch.arange(5) > 1).sum())
    assert c._pending is not None and c._host == 3  # not read yet
    with torch.inference_mode():
        c.add(torch.tensor(2))  # an inference tensor, summed out of place
    c.add(torch.tensor(1))
    assert reg.summary()["counters"] == {"n": 13}
    assert c._pending is None and c.value == 13
    reg.reset()
    assert reg.summary()["counters"] == {}


# --------------------------------------------------------------------------------------
# flash attention's count_mask
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
def test_flash_count_mask_matches_reference(per_slot):
    """T = 37 keys in chunks of 16: 11 KV_PAD lanes in the last chunk, not
    counted; key 5 an empty slot (k_pos = -1), counted."""
    _telemetry_on()
    tcfg = ApproxConfig(mode="table_pack_ref", e_a=EA, attn_table=True)
    jcfg = JApprox(mode="table_pack_ref", e_a=EA, attn_table=True)
    texp, jexp = tcfg.attn_exp("cpu"), jcfg.attn_exp()
    assert texp.wants_count_mask and jexp.wants_count_mask
    rng = np.random.default_rng(1)
    B, Sq, G, Qg, D, T = 2, 3, 2, 1, 8, 37
    q = rng.normal(0, 1, (B, Sq, G, Qg, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, T, G, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, G, D)).astype(np.float32)
    k_pos = np.arange(T, dtype=np.int32)
    k_pos[5] = -1
    q_pos = np.arange(T - Sq, T, dtype=np.int32)
    if per_slot:
        k_pos = np.stack([k_pos, np.roll(k_pos, 1)])
        q_pos = np.stack([q_pos, q_pos - 1])
    kw = dict(causal=True, window=0, kv_chunk=16, scale=D ** -0.5)
    got = t_attention._flash_inner(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
                                   exp_fn=texp, **kw)
    want = jax.jit(lambda *a: j_attention._flash_inner(*a, exp_fn=jexp, **kw))(
        *map(jnp.asarray, (q, k, v, q_pos, k_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    tc, jc = _counters()
    assert tc == jc
    rows = B * Sq * G * Qg
    # p counts the 37 real keys of the 48 lanes, alpha every row a chunk
    assert tc["approx.lookups.attn_exp"] == rows * T + 3 * rows
    # the empty slot and the causally masked keys underflow in p
    assert tc["approx.oob.attn_exp"] > rows


# --------------------------------------------------------------------------------------
# serving, training and build counts
# --------------------------------------------------------------------------------------


def _pair(mode, n_layers=2, **kw):
    """Reference and port configs of reduced stablelm at ``n_layers``."""
    jcfg = j_reduced("stablelm-3b").replace(
        n_layers=n_layers, compute_dtype="float32",
        approx=JApprox(mode=mode, e_a=EA, attn_table=True), **kw)
    tcfg = reduced("stablelm-3b").replace(
        n_layers=n_layers, compute_dtype="float32",
        approx=ApproxConfig(mode=mode, e_a=EA, attn_table=True), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-0 weights of the 2-layer model and the port's
    copy (one init for the file: the reference's takes seconds)."""
    jcfg, tcfg = _pair("table_pack_ref")
    jp = j_build_model(jcfg).init(jax.random.key(0))
    return jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def served(weights):
    """The mixed-EOS queue served by ContinuousEngine, telemetry on, in both
    packages (table_pack_ref + TableFlash), and telemetry off in the port."""
    _clean()
    jp, tp = weights
    jcfg, tcfg = _pair("table_pack_ref")
    off = build_model(tcfg, device="cpu")
    _telemetry_on()
    jm, tm = j_build_model(jcfg), build_model(tcfg, device="cpu")
    reqs = mixed_requests(np.random.default_rng(3), 8)
    jeng = JContinuousEngine(jm, jp, batch_size=2, cache_len=64)
    want = jeng.serve(reqs)
    teng = ContinuousEngine(tm, tp, batch_size=2, cache_len=64)
    got = teng.serve(reqs)
    counters = _counters()
    _clean()
    base = ContinuousEngine(off, tp, batch_size=2, cache_len=64).serve(reqs)
    return dict(want=want, got=got, base=base, counters=counters, jeng=jeng,
                teng=teng, models=(jm, jp, off, tp))


def test_serving_counters_match_reference(served):
    got, want = served["counters"]
    assert got == want
    assert {"approx.lookups.attn_exp", "approx.lookups.silu"} <= set(got)
    for a, b, c in zip(served["want"], served["got"], served["base"]):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, c.tokens)
    assert obs.get_registry().summary()["counters"] == {}  # the off run


def test_training_counters_match_reference(weights):
    """One remat'd step: every layer's activations are counted in its forward
    and again in its recompute, on both sides."""
    jcfg, tcfg = _pair("table_pack_ref", remat=True)
    _telemetry_on()
    jm, tm = j_build_model(jcfg), build_model(tcfg, device="cpu")
    jp = weights[0]
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=1)
    jstate = {"params": jp, "opt": j_adamw.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    b = SyntheticLM(DataConfig(vocab=tcfg.vocab, global_batch=4, seq_len=16)).batch_at(0)
    jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**opt)))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    make_train_step(tm, adamw.AdamWConfig(**opt))(tstate, batch_to(b, "cpu"))
    got, want = _counters()
    assert got == want
    # 4 x 16 tokens x d_ff gates, twice a layer (forward, recompute)
    assert got["approx.lookups.silu"] == 2 * tcfg.n_layers * 4 * 16 * tcfg.d_ff


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_build_counts_match_reference(served, scheduler):
    """compile_counts() is the reference's on the serving tests' queue, and
    host-side obs flipped on between serves changes neither it nor the
    tokens."""
    jm, jp, tm, tp = served["models"]
    reqs = mixed_requests(np.random.default_rng(3), 8)
    if scheduler == "continuous":
        jeng = JContinuousEngine(jm, jp, batch_size=2, cache_len=64)
        teng = ContinuousEngine(tm, tp, batch_size=2, cache_len=64)
        jeng.serve(reqs)
        before = teng.serve(reqs)
        obs.configure(enabled=True)
        after = teng.serve(reqs)
    else:  # two groups: a prefill width each
        reqs = reqs[:4]
        jeng = JDecodeEngine(jm, jp, 2, 64)
        teng = DecodeEngine(tm, tp, 2, 64)
        j_serve_static(jm, jp, reqs, 2, 64, engine=jeng)
        before = serve_static(tm, tp, reqs, 2, 64, engine=teng)
        obs.configure(enabled=True)
        after = serve_static(tm, tp, reqs, 2, 64, engine=teng)
    want = jeng.compile_counts()
    assert -1 not in want.values()
    assert teng.compile_counts() == want
    if scheduler == "continuous":
        assert want == {"prefill": 1, "decode_step": 1}
        assert served["teng"].compile_counts() == served["jeng"].compile_counts()
    teng.reset_counters()
    assert teng.compile_counts() == want
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# --------------------------------------------------------------------------------------
# report layer and CLIs
# --------------------------------------------------------------------------------------


def _mini_doc(scale=1.0):
    """The reference's test trace, with X events, a compiled span, counters
    and an engine summary beside it."""
    evs = []
    t = 0.0
    for i in range(3):
        evs.append({"name": "work", "ph": "B", "ts": t, "pid": 1, "tid": 0})
        evs.append({"name": "work", "ph": "E", "ts": t + 100.0 * scale, "pid": 1,
                    "tid": 0, "args": {"compiled": i == 0}})
        evs.append({"name": "x", "ph": "X", "ts": t, "dur": 7.0 * scale, "pid": 1,
                    "tid": 1})
        t += 200.0 * scale
    return {"traceEvents": evs,
            "metadata": {"metrics": {
                "histograms": {"ttft_s": {"count": 3, "mean": 0.01 * scale,
                                          "p50": 0.01 * scale, "p95": 0.02 * scale,
                                          "p99": 0.03 * scale}},
                "counters": {"approx.oob.gelu": 3, "approx.lookups.gelu": 64}},
                "summary": {"requests": 3, "tok_s_wall": 12.5 * scale}}}


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_report_matches_reference(scale):
    a, b = _mini_doc(), _mini_doc(scale)
    assert span_stats(b) == j_span_stats(b)
    assert render_summary(b, "run") == j_render(b, "run")
    assert diff_summaries(a, b) == j_diff(a, b)
    sa, sb = (d["metadata"]["metrics"] for d in (a, b))
    assert merge_summaries(sa, sb, None) == j_merge_summaries(sa, sb, None)


def _cli_trace(main, argv, path, capsys):
    main(argv + ["--device", "cpu", "--obs", "--trace", str(path)])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"): out.rindex("}") + 1])
    with open(path) as f:
        doc = json.load(f)
    assert validate_trace(doc) == []
    return summary, doc


def test_serve_cli_obs_trace(served, tmp_path, capsys):
    from repro_torch.launch.serve import main

    summary, doc = _cli_trace(main, [
        "--arch", "stablelm-3b", "--reduced", "--requests", "3", "--max-new", "3",
        "--approx-mode", "table_pack_ref", "--approx-ea", "1e-3", "--attn-table"],
        tmp_path / "s.json", capsys)
    counters = doc["metadata"]["metrics"]["counters"]
    assert counters == summary["metrics"]["counters"]
    assert set(counters) == set(served["counters"][1])  # the reference's names
    assert summary["engine_metrics"]["histograms"]["ttft_s"]["count"] == 3
    assert {"refill.prefill", "decode.span"} <= {e["name"] for e in doc["traceEvents"]}
    text = render_summary(doc, "serve")
    assert "approx.oob.attn_exp" in text and "decode.span" in text


def test_train_cli_obs_trace(tmp_path, capsys):
    from repro_torch.launch.train import main

    summary, doc = _cli_trace(main, [
        "--arch", "stablelm-3b", "--reduced", "--steps", "1", "--batch", "2",
        "--seq", "8", "--approx-mode", "quant_pack_ref", "--approx-ea", "1e-3",
        "--ckpt-dir",
        str(tmp_path / "ck")], tmp_path / "t.json", capsys)
    counters = doc["metadata"]["metrics"]["counters"]
    assert counters == summary["counters"]
    names = {f"approx.{k}.{m}" for k in ("oob", "lookups", "quant_sat",
                                         "quant_gathers") for m in ("gelu", "silu")}
    assert set(counters) and set(counters) <= names
    assert counters["approx.quant_gathers.silu"] == 2 * counters["approx.lookups.silu"]


def _load(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_decode_example_and_report_cli(tmp_path, capsys):
    """``examples/serve_decode_torch.py`` on the CPU with ``--obs --trace``
    and its routed demo; ``tools/torch_obs_report.py`` renders the trace,
    and diffs it against itself, as the reference's report does."""
    root = Path(__file__).resolve().parent.parent
    example = _load(root / "examples" / "serve_decode_torch.py")
    trace = tmp_path / "serve.json"
    example.main(["--device", "cpu", "--mode", "table_pack_ref", "--attn-table",
                  "--requests", "2", "--max-new", "2", "--obs", "--trace", str(trace)])
    out = capsys.readouterr().out
    assert "serve_decode OK" in out and "builds {'prefill': 1, 'decode_step': 1}" in out
    example.main(["--device", "cpu", "--mode", "routed_pack_ref", "--routed-demo"])
    assert "routed_demo OK" in capsys.readouterr().out
    with open(trace) as f:
        doc = json.load(f)
    assert validate_trace(doc) == []
    assert doc["metadata"]["metrics"]["counters"]["approx.lookups.gelu"] > 0
    report = _load(root / "tools" / "torch_obs_report.py")
    report.main([str(trace)])
    assert capsys.readouterr().out == j_render(doc, str(trace)) + "\n"
    report.main([str(trace), "--baseline", str(trace)])
    assert capsys.readouterr().out == j_diff(doc, doc, str(trace), str(trace)) + "\n"
