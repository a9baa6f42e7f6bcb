"""The port's Llama against the JAX package's, on the CPU, with JAX's own
weights carried across by ``convert.llama_state_dict_from_jax``.

fp32 (the ``tiny`` preset's dtype): logits within 1e-4 absolute — the
same weights and the same op order, differing only in the order of fp32
sums.  bf16: within 0.08 absolute, because the two frameworks round
activations to bf16 at different places (inside the silu, the matmul
epilogues) and bf16 keeps about 3 significant digits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.models.llama import Llama as JaxLlama
from tpucfn.models.llama import LlamaConfig as JaxConfig
from tpucfn_torch.models.convert import llama_state_dict_from_jax
from tpucfn_torch.models.llama import Llama, LlamaConfig

FP32_ATOL = 1e-4
BF16_ATOL = 0.08

# The suite runs several pytest workers side by side on the CPU; torch's
# intra-op pool would otherwise claim every core in each of them and starve
# the JAX tests' multi-device collectives in the other workers.
torch.set_num_threads(1)


def _configs(dtype_name="float32", max_seq=64, scan_layers=True):
    jcfg = dataclasses.replace(JaxConfig.tiny(), max_seq=max_seq,
                               dtype=getattr(jnp, dtype_name),
                               scan_layers=scan_layers)
    pcfg = dataclasses.replace(LlamaConfig.tiny(), max_seq=max_seq,
                               dtype=getattr(torch, dtype_name))
    return jcfg, pcfg


def _carry(jcfg, pcfg, seed=2):
    params = JaxLlama(jcfg).init(jax.random.key(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    params_np = jax.tree.map(np.asarray, params)
    return params, llama_state_dict_from_jax(params_np, pcfg)


@pytest.fixture(scope="module")
def fp32():
    jcfg, pcfg = _configs()
    params, sd = _carry(jcfg, pcfg)
    return jcfg, pcfg, params, sd


@pytest.mark.parametrize("scan_layers", [True, False])
def test_convert_shapes_and_parameter_count(scan_layers):
    jcfg, pcfg = _configs(scan_layers=scan_layers)
    params, sd = _carry(jcfg, pcfg)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax
    model = Llama.from_state_dict(pcfg, sd)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert sd["layers.1.attn.q_proj.weight"].shape == (64, 64)
    assert sd["layers.0.attn.k_proj.weight"].shape == (32, 64)
    assert sd["lm_head.weight"].shape == (256, 64)
    lead = (params["layers"] if scan_layers else params["layers_1"])
    kernel = np.asarray(lead["mlp"]["down_proj"]["kernel"])
    kernel = kernel[1] if scan_layers else kernel
    np.testing.assert_array_equal(sd["layers.1.mlp.down_proj.weight"].numpy(),
                                  kernel.T)


def test_non_decode_logits_match_jax(fp32):
    jcfg, pcfg, params, sd = fp32
    tokens = np.random.RandomState(0).randint(0, 256, (2, 24)).astype(np.int32)
    ref = JaxLlama(jcfg).apply({"params": params}, jnp.asarray(tokens))
    out = Llama.from_state_dict(pcfg, sd)(torch.from_numpy(tokens))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FP32_ATOL, rtol=0)


def _jax_decode_run(jcfg, params, prompt, steps):
    """Prefill + ``steps`` one-token decode calls in JAX's decode mode,
    greedy; returns the logits of every call."""
    model = JaxLlama(jcfg, decode=True)
    cache = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((prompt.shape[0], 1), jnp.int32)))["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cache)
    logits, muts = model.apply({"params": params, "cache": cache},
                               jnp.asarray(prompt), mutable=["cache"])
    outs = [np.asarray(logits)]
    for _ in range(steps):
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        logits, muts = model.apply({"params": params,
                                    "cache": muts["cache"]}, tok,
                                   mutable=["cache"])
        outs.append(np.asarray(logits))
    return outs


def _port_decode_run(pcfg, sd, prompt, steps):
    model = Llama.from_state_dict(pcfg, sd, decode=True)
    cache = model.init_cache(prompt.shape[0])
    with torch.no_grad():
        logits = model(torch.from_numpy(prompt).long(), cache=cache)
        outs = [logits.float().numpy()]
        for _ in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None]
            logits = model(tok, cache=cache)
            outs.append(logits.float().numpy())
    assert cache.index.tolist() == [prompt.shape[1] + steps] * prompt.shape[0]
    return outs


def test_decode_prefill_and_four_steps_match_jax(fp32):
    jcfg, pcfg, params, sd = fp32
    prompt = np.random.RandomState(1).randint(0, 256, (2, 9)).astype(np.int32)
    ref = _jax_decode_run(jcfg, params, prompt, 4)
    out = _port_decode_run(pcfg, sd, prompt, 4)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o, r, atol=FP32_ATOL, rtol=0)


def test_decode_bf16_matches_jax_loosely():
    jcfg, pcfg = _configs("bfloat16")
    params, sd = _carry(jcfg, pcfg, seed=4)
    assert sd["layers.0.attn.q_proj.weight"].dtype == torch.bfloat16
    assert sd["lm_head.weight"].dtype == torch.float32
    prompt = np.random.RandomState(2).randint(0, 256, (2, 7)).astype(np.int32)
    ref = _jax_decode_run(jcfg, params, prompt, 4)
    out = _port_decode_run(pcfg, sd, prompt, 4)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o, r, atol=BF16_ATOL, rtol=0)


def test_decode_past_capacity_poisons_output(fp32):
    """Decoding past max_seq gives NaN logits (the JAX package's loud
    overflow), never a silently clamped answer."""
    _, pcfg, _, sd = fp32
    cfg = dataclasses.replace(pcfg, max_seq=8)
    model = Llama.from_state_dict(cfg, sd, decode=True)
    cache = model.init_cache(1)
    with torch.no_grad():
        assert torch.isfinite(model(torch.arange(8)[None], cache=cache)).all()
        assert torch.isnan(model(torch.tensor([[3]]), cache=cache)).all()


def test_moe_config_refused():
    with pytest.raises(NotImplementedError):
        Llama(dataclasses.replace(LlamaConfig.tiny(), moe=object()))
