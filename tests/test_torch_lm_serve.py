"""The port's serving path (repro_torch.models.transformer, serve.step,
launch.serve) against the JAX package's on reduced zamba2 (hybrid),
qwen2.5 (dense, GQA with QKV bias) and mamba2 (ssm), for both impls: the
same parameters (JAX's ``init_params(PRNGKey(0))`` converted with
``params_from_jax``) and the same prompts.  JAX runs jitted, as it serves;
its Pallas kernels run in interpret mode.

Contract: logits and every cache leaf within ``MODEL_ULPS`` = 4 bf16 ulps
of the leaf's largest magnitude.  Module by module the two packages agree
within one ulp (test_torch_lm_layers.py); under ``jax.jit`` XLA drops
some of the bf16 roundings the source writes (shown there by
``test_jit_drops_the_bf16_rounding_the_port_keeps``), and a rounding that
lands one ulp apart in one layer is carried through the bf16 residual
stream into the next.  Observed on this CPU: at most 2.5 ulps.  Greedy
tokens must be equal wherever JAX's top-2 logit margin exceeds twice that
bound (each side may move by the bound).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.step import _load_prefill as jload_prefill  # noqa: E402
from repro.serve.step import generate as jgenerate  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.config import config_from_jax  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.step import _load_prefill as tload_prefill  # noqa: E402
from repro_torch.serve.step import generate as tgenerate  # noqa: E402
from repro_torch.serve.step import sample_top_k  # noqa: E402

ARCHS = ["zamba2_1_2b", "qwen2_5_3b", "mamba2_1_3b"]
JIMPLS = ["xla", "pallas"]
B, S, T = 2, 32, 8          # S: a multiple of the reduced ssm_chunk (16)
MODEL_ULPS = 4


def ulp_bf16(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def tol_for(ref) -> float:
    return MODEL_ULPS * ulp_bf16(max(float(np.abs(ref).max()), 1e-30))


def assert_model_close(got, ref, what):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol_for(ref),
                               err_msg=what)


def cache_leaves(cache):
    """Leaves in JAX's tree order (dict keys sorted, tuples in order)."""
    return [leaf for k in sorted(cache) for leaf in cache[k]]


@functools.lru_cache(maxsize=None)
def jax_run(arch, jimpl):
    """JAX's side of one (arch, impl), computed once per worker: prefill
    logits and cache, the greedy generate tokens, and the teacher-forced
    decode logits with those tokens fed."""
    jcfg = dataclasses.replace(jget_reduced(arch), attn_impl=jimpl,
                               ssm_impl=jimpl)
    params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(prompt)}
    logits, cache, _ = jax.jit(functools.partial(jtr.prefill, jcfg))(
        params, batch)
    gen = np.asarray(jax.jit(functools.partial(jgenerate, jcfg, n_steps=T))(
        params, batch))
    first = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    feed = np.concatenate([first[:, None], gen[:, :-1]], axis=1)
    full = jload_prefill(jcfg, jtr.init_cache(jcfg, B, S + T), cache, S)
    step = jax.jit(functools.partial(jtr.decode_step, jcfg))
    dec = []
    for t in range(T):
        lg, full = step(params, jnp.asarray(feed[:, t:t + 1]), full,
                        jnp.array(S + t, jnp.int32))
        dec.append(np.asarray(lg))
    hidden, _ = jax.jit(functools.partial(jtr.forward_train, jcfg))(
        params, batch)
    return dict(cfg=jcfg, params=jax.tree.map(np.asarray, params),
                prompt=prompt, logits=np.asarray(logits),
                cache=[np.asarray(a, np.float32) for a in
                       jax.tree.leaves(cache)],
                gen=gen, feed=feed, dec=dec,
                hidden=np.asarray(hidden, np.float32))


def port_side(arch, jimpl):
    j = jax_run(arch, jimpl)
    cfg = config_from_jax(j["cfg"])
    params = params_from_jax(j["params"], cfg, "cpu")
    return j, cfg, params, {"tokens": torch.from_numpy(j["prompt"])}


cases = pytest.mark.parametrize("arch,jimpl", [(a, i) for a in ARCHS
                                               for i in JIMPLS])


@cases
def test_prefill_matches_jax(arch, jimpl):
    j, cfg, params, batch = port_side(arch, jimpl)
    assert cfg.attn_impl == {"xla": "ref", "pallas": "kernel"}[jimpl]
    logits, cache, seq_len = ttr.prefill(cfg, params, batch)
    assert seq_len == S and logits.dtype == torch.float32
    assert_model_close(logits, j["logits"], "prefill logits")
    leaves = cache_leaves(cache)
    assert len(leaves) == len(j["cache"])
    for i, (got, ref) in enumerate(zip(leaves, j["cache"])):
        assert_model_close(got, ref, f"cache leaf {i}")


@cases
def test_decode_teacher_forced_matches_jax(arch, jimpl):
    j, cfg, params, batch = port_side(arch, jimpl)
    _, pf_cache, _ = ttr.prefill(cfg, params, batch)
    cache = tload_prefill(cfg, ttr.init_cache(cfg, B, S + T, device="cpu"),
                          pf_cache, S)
    for t in range(T):
        lg, cache = ttr.decode_step(
            cfg, params, torch.from_numpy(j["feed"][:, t:t + 1]), cache,
            S + t)
        assert_model_close(lg, j["dec"][t], f"decode step {t}")


def top2_margin(logits):
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


@cases
def test_generate_matches_jax_where_the_margin_is_clear(arch, jimpl):
    """Row by row, while both runs have fed the same tokens: the greedy
    token agrees wherever JAX's top-2 margin exceeds twice the logits
    bound."""
    j, cfg, params, batch = port_side(arch, jimpl)
    toks = tgenerate(cfg, params, batch, T)
    assert toks.shape == (B, T) and toks.dtype == torch.int32
    toks = toks.numpy()
    # step t's token is the argmax of the logits after feed[:, t]; feed[:,
    # 0] is the prefill's argmax
    port_first = ttr.prefill(cfg, params, batch)[0].argmax(-1).numpy()
    compared = 0
    for b in range(B):
        steps = [(j["logits"], port_first[b], j["feed"][b, 0])] + [
            (j["dec"][t], toks[b, t], j["gen"][b, t]) for t in range(T)]
        for lg, got, want in steps:
            if top2_margin(lg)[b] > 2 * tol_for(lg):
                assert got == want, (b, compared)
                compared += 1
            if got != want:
                break            # the runs now feed different tokens
    assert compared >= B * (T + 1) // 2, compared


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    j, cfg, params, batch = port_side(arch, "pallas")
    hidden, aux = ttr.forward_train(cfg, params, batch)
    assert float(aux) == 0.0
    assert_model_close(hidden, j["hidden"], "hidden")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own KV/state-cache check (as tests/test_models.py does
    for the JAX package): teacher-forced decode logits follow the full
    forward's position by position."""
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="kernel",
                              ssm_impl="kernel")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    n = 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, n)).astype(np.int32))
    hidden, _ = ttr.forward_train(cfg, params, {"tokens": toks})
    full = (hidden.to(torch.bfloat16) @ params["unembed"]).float()
    half = n // 2
    _, pf_cache, _ = ttr.prefill(cfg, params, {"tokens": toks[:, :half]})
    cache = tload_prefill(cfg, ttr.init_cache(cfg, 1, n, device="cpu"),
                          pf_cache, half)
    for t in range(half, n):
        lg, cache = ttr.decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        ref, got = full[0, t].numpy(), lg[0].numpy()
        corr = float(ref @ got) / (np.linalg.norm(ref) * np.linalg.norm(got)
                                   + 1e-9)
        assert corr > 0.99, (arch, t, corr)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jcfg = jget_reduced(arch)
    jc = jax.eval_shape(lambda: jtr.init_cache(jcfg, 3, 40))
    tc = ttr.init_cache(config_from_jax(jcfg), 3, 40, device="cpu")
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jc)]
    got = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for a in cache_leaves(tc)]
    assert got == want
    assert all(not a.any() for a in cache_leaves(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """Same names and shapes as JAX's tree; the bf16 leaves in bf16."""
    jcfg = jget_reduced(arch)
    jp = jax.eval_shape(lambda: jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = ttr.init_params(config_from_jax(jcfg), seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(k): v.shape for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                walk(v, key)
            else:
                tflat[key] = tuple(v.shape)
                want = (torch.bfloat16 if k in ttr.BF16_LEAVES
                        else torch.float32)
                assert v.dtype == want, key
    walk(tp, "")
    assert tflat == {k: tuple(v) for k, v in jflat.items()}


def test_param_counts_match_jax():
    from repro.configs import get_config as jget_config
    for arch in ARCH_IDS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        assert config_from_jax(jcfg) == cfg
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.n_attn_applications == jcfg.n_attn_applications
    assert get_config("zamba2-1.2b").n_attn_applications == 6


def test_serve_launcher_on_cpu_equals_generate():
    out = tserve.main(["--device", "cpu", "--reduced", "--arch",
                       "zamba2-1.2b", "--batch", "2", "--prompt-len", "32",
                       "--gen", "4"])
    cfg = dataclasses.replace(get_reduced("zamba2-1.2b"), attn_impl="kernel",
                              ssm_impl="kernel")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    batch = tserve.prompt_batch(cfg, 2, 32, 0, "cpu")
    assert torch.equal(out["tokens"], tgenerate(cfg, params, batch, 4))
    # the CPU runs the plain versions: no kernel launched
    assert not any(out["prefill_launches"].values())
    assert out["prefill_ms"] > 0 and out["decode_tok_s"] > 0


def test_serve_launcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--reduced", "--arch", "zamba2-1.2b"])


def test_sample_top_k_draws_from_the_top_k():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 4.0, -3.0, 4.5]] * 64)
    draws = sample_top_k(gen, logits, k=2)
    assert set(draws.tolist()) <= {1, 4} and len(set(draws.tolist())) == 2
    again = sample_top_k(torch.Generator().manual_seed(0), logits, k=2)
    assert torch.equal(draws, again)
