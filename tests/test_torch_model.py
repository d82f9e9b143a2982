"""The port's dense decoder and serving engines against the JAX reference, on
``reduced("stablelm-3b")`` (2 layers, d=64) with the reference's own weights
carried over by ``params_from_jax``.

Tolerances, with their reasons:

* ``compute_dtype="float32"``: prefill and decode logits within 1e-4 absolute
  (the two frameworks sum the matrix products in different orders; the
  lookups themselves agree to 1 ULP);
* bf16: within 2e-2 of the largest logit (bf16 rounds at other places in the
  two frameworks, and eager vs compiled bf16 differ at that level);
* greedy tokens: identical, in float32, to the reference's ContinuousEngine on
  the mixed-EOS queue of ``tests/test_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import ApproxConfig as JApprox
from repro.models import ARCH_IDS as J_ARCH_IDS
from repro.models import build_model as j_build_model
from repro.models import get_config as j_get_config
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro_torch.approx import ApproxConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import ARCH_IDS, build_model, get_config, reduced
from repro_torch.serving.engine import (ContinuousEngine, DecodeEngine, Request,
                                        _trim_at_eos, cache_batch_axes,
                                        scatter_cache_slots, serve_static)
from tests.test_archs import reduced as j_reduced
from tests.test_serving import mixed_requests

APPROX = {  # name -> (mode, attn_table, e_a)
    "exact": ("exact", False, 1e-4),
    "table_ref": ("table_ref", False, 1e-4),
    "table_pack": ("table_pack", False, 1e-6),
    "table_pack_attn": ("table_pack", True, 1e-6),
}


def pair(approx: str, compute_dtype: str = "float32"):
    """(jax model, jax params, port model, port params) on the same weights."""
    mode, attn, e_a = APPROX[approx]
    jcfg = j_reduced("stablelm-3b").replace(
        compute_dtype=compute_dtype,
        approx=JApprox(mode=mode, e_a=e_a, omega=0.2, attn_table=attn))
    tcfg = reduced("stablelm-3b").replace(
        compute_dtype=compute_dtype,
        approx=ApproxConfig(mode=mode, e_a=e_a, omega=0.2, attn_table=attn))
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _asdict(cfg):
    d = dataclasses.asdict(cfg)
    d["approx"] = dataclasses.asdict(cfg.approx)
    return d


class TestConfig:
    def test_stablelm_fields_equal(self):
        assert _asdict(get_config("stablelm-3b")) == _asdict(j_get_config("stablelm-3b"))

    def test_reduced_and_geometry_equal(self):
        t, j = reduced("stablelm-3b"), j_reduced("stablelm-3b")
        assert _asdict(t) == _asdict(j)
        assert dataclasses.asdict(t.attn_geom) == dataclasses.asdict(j.attn_geom)
        full = get_config("stablelm-3b")
        assert full.param_count() == j_get_config("stablelm-3b").param_count()
        assert (full.vocab_pad, full.head_dim) == (51200, 80)

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_dense_family_fields_and_param_count_equal(self, arch):
        """Each ported id's config, its reduced config and geometry equal the
        reference's field for field, and so does ``param_count`` at full width."""
        t, j = get_config(arch), j_get_config(arch)
        assert _asdict(t) == _asdict(j)
        assert t.param_count() == j.param_count()
        assert (t.vocab_pad, t.head_dim) == (j.vocab_pad, j.head_dim)
        assert _asdict(reduced(arch)) == _asdict(j_reduced(arch))
        assert (dataclasses.asdict(reduced(arch).attn_geom)
                == dataclasses.asdict(j_reduced(arch).attn_geom))

    def test_unported_archs_raise(self):
        """Every one of the reference's ids is ported, in its order; an
        unknown id is refused."""
        assert ARCH_IDS == J_ARCH_IDS
        with pytest.raises(NotImplementedError, match="unknown architecture"):
            get_config("whisper-tiny")


class TestLogits:
    @pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("approx", sorted(APPROX))
    def test_prefill_and_decode(self, approx, compute_dtype):
        jm, jp, tm, tp = pair(approx, compute_dtype)
        V = tm.cfg.vocab
        rng = np.random.default_rng(0)
        toks = rng.integers(0, V, (2, 9)).astype(np.int32)
        jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
        assert tc["k"].shape == jc["k"].shape and tc["pos"].shape == jc["pos"].shape
        outs = []
        with torch.inference_mode():
            jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
            tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
            outs.append((jl, tl))
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
            # per-slot (B,) clocks, then a shared scalar clock
            for pos in (np.asarray([9, 9], np.int32), np.int32(10)):
                jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok),
                                                 jnp.asarray(pos), jc)
                tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(),
                                        torch.as_tensor(pos), tc)
                outs.append((jl, tl))
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for jl, tl in outs:
            want, got = np.asarray(jl)[:, :V], tl.numpy()[:, :V]
            assert np.isfinite(got).all()
            err = np.abs(got - want).max()
            if compute_dtype == "float32":
                assert err <= 1e-4, err
            else:
                assert err <= 2e-2 * np.abs(want).max(), err
            assert (tl.numpy()[:, V:] == -1e30).all()  # padded vocab masked


@pytest.mark.parametrize("approx", ["exact", "table_pack", "table_pack_attn"])
def test_greedy_tokens_match_reference_engine(approx):
    jm, jp, tm, tp = pair(approx)
    assert (tm.attn_exp is not None) == (approx == "table_pack_attn")
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    got = ContinuousEngine(tm, tp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")
        assert (b.steps, b.prompt_len) == (a.steps, a.prompt_len)


@pytest.fixture(scope="module")
def port_model():
    cfg = reduced("stablelm-3b").replace(approx=ApproxConfig(
        mode="table_pack", e_a=1e-4, omega=0.2, attn_table=True))
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


class TestPortEngine:
    def test_continuous_matches_sequential_oracle(self, port_model):
        """The port's ContinuousEngine (refills, per-slot clocks) against its
        own fixed-batch engine serving each request alone at the same width."""
        model, params = port_model
        reqs = mixed_requests(np.random.default_rng(4), 8, lo_new=2, hi_new=6)
        S0 = max(len(r.prompt) for r in reqs)
        eng = ContinuousEngine(model, params, batch_size=2, cache_len=64)
        out = eng.serve(reqs)
        assert eng.refills >= 2
        oracle = DecodeEngine(model, params, 2, 64)
        for i, r in enumerate(reqs):
            row = np.zeros((S0,), np.int32)
            row[S0 - len(r.prompt):] = r.prompt
            gen, _ = oracle.generate_batch(np.tile(row, (2, 1)), r.max_new_tokens,
                                           r.eos_id)
            want = _trim_at_eos(gen[0], r.max_new_tokens, r.eos_id)
            np.testing.assert_array_equal(out[i].tokens, want, err_msg=f"req {i}")
            assert out[i].steps == len(out[i].tokens)

    def test_static_accounting_and_zero_budget(self, port_model):
        model, params = port_model
        rng = np.random.default_rng(9)
        reqs = [Request(prompt=rng.integers(0, 100, (4,)).astype(np.int32),
                        max_new_tokens=m) for m in (3, 0, 2, 0, 5)]
        eng = DecodeEngine(model, params, 2, 64)
        stat = serve_static(model, params, reqs, 2, 64, engine=eng)
        cont = ContinuousEngine(model, params, 2, 64).serve(reqs)
        for res in (stat, cont):
            assert [r.steps for r in res] == [3, 0, 2, 0, 5]
        assert eng.batch_steps > 0 and 0 < eng.wasted_fraction < 1

    def test_sampling_is_per_request_reproducible(self, port_model):
        model, params = port_model
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, 100, (4,)).astype(np.int32) for _ in range(3)]
        mk = lambda order, budgets: [Request(prompt=prompts[i], max_new_tokens=b)
                                     for i, b in zip(order, budgets)]
        run = lambda order, budgets, seed: ContinuousEngine(
            model, params, 2, 64, temperature=1.0, seed=seed).serve(mk(order, budgets))
        a1, a2 = run((0, 1, 2), (6, 2, 4), 9), run((0, 1, 2), (6, 2, 4), 9)
        for r1, r2 in zip(a1, a2):
            np.testing.assert_array_equal(r1.tokens, r2.tokens)
        b = run((1, 0, 2), (2, 6, 4), 9)  # request 2 lands in another slot
        np.testing.assert_array_equal(a1[2].tokens, b[2].tokens)
        c = run((0, 1, 2), (6, 2, 4), 10)
        assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a1, c))

    def test_cache_axes_and_scatter(self, port_model):
        model, _ = port_model
        assert cache_batch_axes(model, 32) == {"k": 1, "v": 1, "pos": 0}
        dst, src = model.init_cache(3, 8), model.init_cache(3, 8)
        src = {k: v + 1 for k, v in src.items()}
        out = scatter_cache_slots(dst, src, [2], cache_batch_axes(model, 8))
        assert (out["pos"][2] == 0).all() and (out["pos"][:2] == -1).all()
        assert (out["k"][:, 2] == 1).all() and (out["k"][:, :2] == 0).all()
        assert (dst["pos"] == -1).all()  # the input cache is left as it was

    def test_cli_runs_on_cpu(self, capsys):
        from repro_torch.launch.serve import main

        res = main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3",
                    "--approx-mode", "table_pack", "--attn-table"])
        assert [r.steps for r in res] == [3, 3, 3]
        assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out
