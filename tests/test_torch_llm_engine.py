"""Parity of ray_tpu_torch/serve/llm.py's LLMEngine against
ray_tpu/serve/llm.py's, in both KV layouts (paged and contiguous) and with
int8 weights, on the ``tiny`` preset in f32 with the same weights (the JAX
engine's own seeded init, carried over by ``params_from_jax``). Greedy
tokens must be identical.

Also here: the port imports neither jax nor ray_tpu (a source scan), its
entry points refuse to run on a CUDA-less machine unless asked for the
CPU, and chip_smoke.py refuses to run without CUDA or outside a checkout.
"""

import inspect
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_support import REPO, jax_reference, jax_tree_to_np

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402


def _engines(kv_layout="paged", **kw):
    """A JAX engine and a port engine with the same config and weights
    (drive the JAX one inside jax_reference())."""
    attn = kw.pop("attn_impl", None)
    window = kw.pop("sliding_window", None)
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jnp.float32,
                                                 sliding_window=window)
        if attn:
            jcfg = jcfg.replace(attn_impl=attn)
        je = ref.llm.LLMEngine(cfg=jcfg, kv_layout=kv_layout, seed=0, **kw)
        params = jax_tree_to_np(je.params)
    tcfg = llama.PRESETS["tiny"].replace(dtype=torch.float32,
                                         sliding_window=window)
    if attn:
        tcfg = tcfg.replace(attn_impl=attn)
    te = LLMEngine(cfg=tcfg, params=llama.params_from_jax(params, "cpu"),
                   kv_layout=kv_layout, device="cpu", **kw)
    return je, te


def _drive(engine, prompts, max_new_tokens):
    """Submit prompts (a list of lists; each inner list is a wave submitted
    after the previous wave got its first step) and drive to completion."""
    reqs = []
    for wave in prompts:
        reqs += [engine.submit(p, max_new_tokens=max_new_tokens)
                 for p in wave]
        engine.step_n(8)
    while engine.has_work():
        engine.step_n(8)
    return [r.generated for r in reqs]


def test_generate_matches_jax_and_known_tokens():
    je, te = _engines(page_size=16)
    with jax_reference():
        jt = je.generate([1, 2, 3, 4, 5], max_new_tokens=6)
    tt = te.generate([1, 2, 3, 4, 5], max_new_tokens=6)
    assert jt == tt == [35, 235, 215, 5, 21, 5]


def test_flash_routed_prompt_matches_jax():
    # 127 tokens -> bucket 128: prefill takes the flash route (the JAX
    # Pallas forward in interpret mode; the port's plain version on CPU)
    je, te = _engines(page_size=16, max_seq_len=256, attn_impl="flash")
    prompt = np.random.default_rng(0).integers(0, 256, 127).tolist()
    with jax_reference():
        jt = je.generate(prompt, max_new_tokens=6)
    assert te.generate(prompt, max_new_tokens=6) == jt
    assert len(jt) == 6


def test_prefix_cache_hit_matches_jax():
    je, te = _engines(page_size=16)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 40).tolist()
    waves = [[shared + [7, 8]],
             [shared + rng.integers(0, 256, 9).tolist(), shared[:35]]]
    with jax_reference():
        jt = _drive(je, waves, 5)
    tt = _drive(te, waves, 5)
    assert tt == jt
    assert te.metrics["prefix_hits"] >= 1
    assert te.metrics["prefix_hits"] == je.metrics["prefix_hits"]


def test_chunked_prefill_matches_jax():
    je, te = _engines(page_size=16, prefill_chunk=16)
    rng = np.random.default_rng(2)
    waves = [[rng.integers(0, 256, 50).tolist(),
              rng.integers(0, 256, 9).tolist()]]
    with jax_reference():
        jt = _drive(je, waves, 6)
    assert _drive(te, waves, 6) == jt


def test_preemption_matches_jax():
    # 8 real pages of 8 tokens: three 20-token prompts growing by 16 each
    # cannot all fit, so the newest is recompute-preempted
    je, te = _engines(page_size=8, num_pages=9, prefix_caching=False)
    rng = np.random.default_rng(3)
    waves = [[rng.integers(0, 256, 20).tolist() for _ in range(3)]]
    with jax_reference():
        jt = _drive(je, waves, 16)
    tt = _drive(te, waves, 16)
    assert tt == jt
    assert te.metrics.get("preemptions", 0) >= 1
    assert all(len(t) == 16 for t in tt)


def test_temperature_sampling_stays_in_vocab():
    te = LLMEngine(preset="tiny", kv_layout="paged", page_size=16,
                   device="cpu")
    reqs = [te.submit([1, 2, 3], max_new_tokens=9, temperature=0.8),
            te.submit([4, 5, 6], max_new_tokens=9)]
    while te.has_work():
        te.step_n(4)
    assert all(len(r.generated) == 9 for r in reqs)
    assert all(0 <= t < 256 for r in reqs for t in r.generated)
    # the greedy row is unaffected by its sampled neighbour
    assert reqs[1].generated == LLMEngine(
        preset="tiny", kv_layout="paged", page_size=16,
        device="cpu").generate(
            [4, 5, 6], max_new_tokens=9)


def test_export_import_kv_pages_round_trip():
    src = LLMEngine(preset="tiny", kv_layout="paged", page_size=16,
                    device="cpu")
    prompt = list(range(1, 40))
    src.generate(prompt, max_new_tokens=2)
    hashes = list(src.pool.hash_to_page)
    pages = [src.pool.hash_to_page[h] for h in hashes]
    k, v = src.export_kv_pages(pages)
    assert k.shape == (2, 2, len(pages), 16, 16)
    dst = LLMEngine(preset="tiny", kv_layout="paged", page_size=16,
                    device="cpu")
    assert dst.import_kv_pages(hashes, k, v) == len(pages)
    assert dst.import_kv_pages(hashes, k, v) == 0     # already registered
    k2, v2 = dst.export_kv_pages([dst.pool.hash_to_page[h] for h in hashes])
    assert torch.equal(k, k2) and torch.equal(v, v2)
    # the imported prefix is adopted without prefill
    assert dst.generate(prompt, max_new_tokens=2) == \
        src.generate(prompt, max_new_tokens=2)
    assert dst.metrics["prefix_hits"] == 1


def test_unported_options_raise():
    """Unknown options raise; mesh= and rules= come together (the sharded
    engine itself, and a mesh that does not divide a dim, are held on 2
    ranks in tests/test_torch_parallel_engine.py)."""
    from ray_tpu_torch.parallel.sharding import ShardingRules

    with pytest.raises(ValueError):
        LLMEngine(preset="tiny", quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="together"):
        LLMEngine(preset="tiny", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="together"):
        LLMEngine(preset="tiny", rules=ShardingRules.fsdp_tp(),
                  device="cpu")


# --- the contiguous layout and int8 weights ---------------------------------------


def test_default_layout_matches_jax():
    with jax_reference() as ref:
        jdef = inspect.signature(ref.llm.LLMEngine).parameters
    tdef = inspect.signature(LLMEngine).parameters
    assert tdef["kv_layout"].default == jdef["kv_layout"].default == \
        "contiguous"
    eng = LLMEngine(preset="tiny", device="cpu")
    assert eng.kv_layout == "contiguous" and eng.pool is None
    assert eng.cache.k.shape == (2, 8, 128, 2, 16)
    with pytest.raises(ValueError, match="paged"):
        eng.export_kv_pages([1])


def test_contiguous_generate_matches_jax_and_known_tokens():
    je, te = _engines("contiguous")
    with jax_reference():
        jt = je.generate([1, 2, 3, 4, 5], max_new_tokens=6)
    tt = te.generate([1, 2, 3, 4, 5], max_new_tokens=6)
    assert jt == tt == [35, 235, 215, 5, 21, 5]


def test_contiguous_chunked_prefill_matches_jax():
    je, te = _engines("contiguous", prefill_chunk=8)
    rng = np.random.default_rng(4)
    waves = [[rng.integers(0, 256, 30).tolist(),
              rng.integers(0, 256, 5).tolist()],
             [rng.integers(0, 256, 19).tolist()]]
    with jax_reference():
        jt = _drive(je, waves, 6)
    tt = _drive(te, waves, 6)
    assert tt == jt
    assert all(len(t) == 6 for t in tt)


def test_contiguous_more_requests_than_slots_matches_jax():
    # 5 requests on 2 slots: queued requests take the rows that finished
    # ones leave, over stale cache contents
    je, te = _engines("contiguous", max_slots=2, max_seq_len=64)
    rng = np.random.default_rng(5)
    waves = [[rng.integers(0, 256, int(n)).tolist() for n in (9, 20, 3)],
             [rng.integers(0, 256, int(n)).tolist() for n in (14, 6)]]
    with jax_reference():
        jt = _drive(je, waves, 7)
    tt = _drive(te, waves, 7)
    assert tt == jt


@pytest.mark.parametrize("attn_impl,plen", [("xla", 40), ("flash", 127)])
def test_contiguous_sliding_window_matches_jax(attn_impl, plen):
    je, te = _engines("contiguous", sliding_window=16, attn_impl=attn_impl,
                      max_seq_len=256)
    prompt = np.random.default_rng(6).integers(0, 256, plen).tolist()
    with jax_reference():
        jt = je.generate(prompt, max_new_tokens=20)
    assert te.generate(prompt, max_new_tokens=20) == jt
    with pytest.raises(ValueError, match="sliding_window"):
        LLMEngine(cfg=te.cfg, params=te.params, kv_layout="paged",
                  device="cpu")


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_int8_engine_matches_jax(kv_layout):
    """The JAX engine quantizes its own seeded init; the port gets the same
    float init and quantizes it itself."""
    with jax_reference() as ref:
        jcfg = ref.llama.PRESETS["tiny"].replace(dtype=jnp.float32)
        je = ref.llm.LLMEngine(cfg=jcfg, kv_layout=kv_layout, seed=0,
                               page_size=16, quantize="int8")
        floats = jax_tree_to_np(ref.llama.init_params(
            jax.random.PRNGKey(0), jcfg.replace(param_dtype=jcfg.dtype)))
        rng = np.random.default_rng(7)
        waves = [[rng.integers(0, 256, 21).tolist(), [1, 2, 3, 4, 5]]]
        jt = _drive(je, waves, 8)
        jq = jax_tree_to_np(je.params)
    te = LLMEngine(cfg=llama.PRESETS["tiny"].replace(dtype=torch.float32),
                   params=llama.params_from_jax(floats, "cpu"),
                   kv_layout=kv_layout, page_size=16, quantize="int8",
                   device="cpu")
    assert te.params["layers"]["wq"]["q8"].dtype == torch.int8
    assert np.array_equal(te.params["lm_head"]["q8"].numpy(),
                          jq["lm_head"]["q8"])
    assert _drive(te, waves, 8) == jt


def test_int8_engine_init_is_quantize_of_init():
    """With params=None an int8 engine draws its init on the host and
    quantizes it leaf by leaf (llama.init_params_int8): the tree equals
    quantize_params_int8 of the whole host init from the same seed bit for
    bit, and an engine given that tree generates the same tokens."""
    eng = LLMEngine(preset="tiny", quantize="int8", seed=3, device="cpu")
    cfg = eng.cfg.replace(param_dtype=eng.cfg.dtype)
    want = llama.quantize_params_int8(
        llama.init_params(torch.Generator().manual_seed(3), cfg))

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{p}/{k}")
        else:
            yield p, t

    got, exp = dict(leaves(eng.params)), dict(leaves(want))
    assert got.keys() == exp.keys() and "/lm_head/q8" in got
    for k, t in exp.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    given = LLMEngine(cfg=eng.cfg, params=want, quantize="int8",
                      device="cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    assert eng.generate(prompt, max_new_tokens=8) == \
        given.generate(prompt, max_new_tokens=8)


def test_paged_matches_contiguous():
    """Same params, same prompts: the paged engine must produce the exact
    greedy tokens the contiguous engine does (the JAX suite's test of the
    same name, on the port)."""
    cont = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=3,
                     device="cpu")
    paged = LLMEngine(preset="tiny", max_slots=4, max_seq_len=64, seed=3,
                      kv_layout="paged", page_size=8, device="cpu")
    for p in ([1, 2, 3], [7, 8, 9, 10, 11], [4] * 17):
        a = cont.generate(p, max_new_tokens=12)
        b = paged.generate(p, max_new_tokens=12)
        assert a == b, (p, a, b)


def test_engine_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(preset="tiny")
    assert LLMEngine(preset="tiny", device="cpu").cfg.dtype == torch.float32


# `ray_tpu\b` does not match `ray_tpu_torch` (no word boundary before "_")
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|ray_tpu)\b", re.M)


def test_import_scan_pattern():
    for bad in ("import jax", "  import jax.numpy as jnp",
                "from jax import numpy", "import ray_tpu",
                "    from ray_tpu.ops import paged_attention"):
        assert _FORBIDDEN.search(bad), bad
    for good in ("import torch", "from ray_tpu_torch.ops import _build",
                 "import ray_tpu_torch", "# import jax"):
        assert not _FORBIDDEN.search(good), good


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in list((REPO / "ray_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_ray_tpu(path):
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(src), f"{path} imports jax or ray_tpu"


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode != 0 and r.stdout == ""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout == ""
