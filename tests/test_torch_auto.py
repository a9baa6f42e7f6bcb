"""The port's dense/flash dispatch policy against the JAX package's.

For the same (S, D, dtype) and the same tune table — a temp file through
``TPUCFN_FLASH_TUNE_CACHE``, read by both — the port's decision equals
JAX's: the evidence core (``_evidence_says_flash``) with the table
present and winning, present and losing, present without a ratio, and
absent; and ``should_use_flash`` on the accelerator (JAX's backend
"tpu", the port's device "cuda") and off it (both CPU), with both length
thresholds set to the JAX package's defaults through their environment
variables.  The port's own defaults (both 0) take the kernels on the card
wherever no measured entry says dense, at the head dims and dtypes the
kernels are built for.  Also the repair of the port's
defaults: ``Llama`` outside decode and the packed attention resolve
through this policy.
"""

import itertools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucfn.kernels.auto as jax_auto
import tpucfn.kernels.flash_autotune as jax_tune
import tpucfn_torch.kernels.auto as auto
import tpucfn_torch.kernels.flash_autotune as tune

KIND = "test-card"
SEQS = (128, 512, 2048, 3000, 4096, 8192, 16384)
DIMS = (64, 128)
DTYPES = ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32))
# table name -> speedup of the families it lists (None: listed without a
# measured ratio; "absent": no entry at all)
TABLES = {"winning": 1.8, "losing": 0.9, "no_ratio": None, "absent": "absent"}


def _write_table(path, speedup):
    table = {}
    if speedup != "absent":
        for s, d, (jdt, _) in itertools.product(SEQS, DIMS, DTYPES):
            key = jax_tune._key(KIND, True, s, d, jdt)
            table[key] = ([128, 128] if speedup is None
                          else [128, 128, speedup])
    path.write_text(json.dumps(table))


@pytest.fixture(params=sorted(TABLES))
def table(request, tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    _write_table(path, TABLES[request.param])
    monkeypatch.setenv("TPUCFN_FLASH_TUNE_CACHE", str(path))
    monkeypatch.setattr(jax_tune, "_MEM_CACHE", None)
    monkeypatch.setattr(tune, "_MEM_CACHE", None)

    class _Dev:
        device_kind = KIND

    monkeypatch.setattr(jax, "devices", lambda *a, **kw: [_Dev()])
    monkeypatch.setattr(tune, "_device_kind", lambda: KIND)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the untuned-kind warning
        yield request.param


@pytest.fixture
def jax_thresholds(monkeypatch):
    """Both length thresholds at the JAX package's defaults, for both."""
    monkeypatch.setenv("TPUCFN_FLASH_MIN_S", "2048")
    monkeypatch.setenv("TPUCFN_FLASH_UNTUNED_MIN_S", "8192")


def test_keys_are_the_jax_keys():
    for s, d, (jdt, tdt) in itertools.product(SEQS, DIMS, DTYPES):
        assert tune._key(KIND, True, s, d, tdt) == \
            jax_tune._key(KIND, True, s, d, jdt)
        assert tune._key(KIND, False, s, d, tdt) == \
            jax_tune._key(KIND, False, s, d, jdt)


def test_evidence_matches_jax(table, jax_thresholds):
    for s, d, (jdt, tdt) in itertools.product(SEQS, DIMS, DTYPES):
        want = jax_auto._evidence_says_flash(s, d, jdt, True)
        got = auto._evidence_says_flash(s, d, tdt, True)
        assert got == want, (table, s, d, tdt)
        assert tune.lookup_speedup(s, d, tdt, True) == \
            jax_tune.lookup_speedup(s, d, jdt, True)


@pytest.mark.parametrize("on_accelerator", [True, False])
def test_should_use_flash_matches_jax(table, on_accelerator, jax_thresholds,
                                      monkeypatch):
    monkeypatch.setattr(jax_auto, "_backend",
                        lambda: "tpu" if on_accelerator else "cpu")
    device = torch.device("cuda" if on_accelerator else "cpu")
    for s, d, (jdt, tdt) in itertools.product(SEQS, DIMS, DTYPES):
        for causal, mask in ((True, None), (False, None), (True, "m")):
            want = jax_auto.should_use_flash(s, causal=causal, mask=mask,
                                             d=d, dtype=jdt)
            got = auto.should_use_flash(s, causal=causal, mask=mask, d=d,
                                        dtype=tdt, device=device)
            assert got == want, (table, s, d, tdt, causal, mask)
        want = jax_auto.should_use_flash_full(s, s, d=d, dtype=jdt)
        got = auto.should_use_flash_full(s, s, d=d, dtype=tdt, device=device)
        assert got == want, (table, s, d, tdt)


@pytest.mark.parametrize("on_card", [True, False])
def test_port_defaults_take_the_kernels_on_the_card(table, on_card,
                                                    monkeypatch):
    """At the port's defaults a CUDA tensor takes the kernels at every
    length unless the table measured dense faster for its family; a CPU
    tensor, a mask and non-causal attention stay dense."""
    monkeypatch.delenv("TPUCFN_FLASH_MIN_S", raising=False)
    monkeypatch.delenv("TPUCFN_FLASH_UNTUNED_MIN_S", raising=False)
    assert auto.flash_threshold() == 0 and auto.untuned_flash_min_s() == 0
    device = torch.device("cuda" if on_card else "cpu")
    for s, d, (_, tdt) in itertools.product(SEQS, DIMS, DTYPES):
        want = on_card and table != "losing"
        assert auto.should_use_flash(s, d=d, dtype=tdt,
                                     device=device) == want, (table, s, d)
        # the tables list causal families only: full attention is unmeasured
        assert auto.should_use_flash_full(s, s, d=d, dtype=tdt,
                                          device=device) == on_card
        assert not auto.should_use_flash(s, d=d, dtype=tdt, device=device,
                                         mask="m")
        assert not auto.should_use_flash(s, causal=False, d=d, dtype=tdt,
                                         device=device)


@pytest.mark.parametrize("d,dtype", [(40, torch.bfloat16),
                                     (40, torch.float32),
                                     (64, torch.float16),
                                     (128, torch.float16)],
                         ids=["d40-bf16", "d40-fp32", "d64-fp16",
                              "d128-fp16"])
def test_unbuilt_head_dim_or_dtype_stays_dense_on_the_card(table, d, dtype,
                                                           monkeypatch):
    """A head dim outside the kernels' ``HEAD_DIMS`` or a dtype outside
    their ``DTYPES`` takes the dense path on a CUDA device, whatever the
    table says (the kernels would refuse it); D = 64 in bf16 follows the
    evidence as before."""
    monkeypatch.delenv("TPUCFN_FLASH_MIN_S", raising=False)
    monkeypatch.delenv("TPUCFN_FLASH_UNTUNED_MIN_S", raising=False)
    for s in SEQS:
        assert not auto.should_use_flash(s, d=d, dtype=dtype, device="cuda")
        assert not auto.should_use_flash_full(s, s, d=d, dtype=dtype,
                                              device="cuda")
        assert auto.should_use_flash(s, d=64, dtype=torch.bfloat16,
                                     device="cuda") == (table != "losing")
        assert auto.should_use_flash_full(s, s, d=64, dtype=torch.bfloat16,
                                          device="cuda")


def test_thresholds_follow_the_same_env(monkeypatch):
    monkeypatch.setenv("TPUCFN_FLASH_MIN_S", "1024")
    monkeypatch.setenv("TPUCFN_FLASH_UNTUNED_MIN_S", "4096")
    assert auto.flash_threshold() == jax_auto.flash_threshold() == 1024
    assert auto.untuned_flash_min_s() == jax_auto.untuned_flash_min_s() == 4096


def test_untuned_card_warns_once(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUCFN_FLASH_UNTUNED_MIN_S", "8192")
    (tmp_path / "t.json").write_text("{}")
    monkeypatch.setenv("TPUCFN_FLASH_TUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setattr(tune, "_MEM_CACHE", None)
    monkeypatch.setattr(tune, "_device_kind", lambda: "untuned-card")
    monkeypatch.setattr(auto, "_warned_untuned_kinds", set())
    with pytest.warns(UserWarning, match="no flash-tune table entries"):
        assert not auto._evidence_says_flash(2048, 64, torch.bfloat16, True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not auto._evidence_says_flash(2048, 64, torch.bfloat16, True)


def test_builtin_table_is_keyed_for_the_port():
    """Every committed entry names a CUDA card, carries a measured ratio
    or none, and the card's name and power limit."""
    raw = json.loads((tune.Path(tune.__file__).parent
                      / "flash_tune_builtin.json").read_text())
    for key, entry in raw.items():
        kind, causal, s, d, dtype = key.split("|")
        assert causal in ("causal", "full") and int(s) == tune._bucket(int(s))
        assert entry[:2] == [None, None] and len(entry) == 4, (key, entry)
        assert entry[3].startswith(kind), (key, entry)


# ---- the repaired defaults -------------------------------------------------

def _spy(monkeypatch):
    """Record which attention each call of the model's layers went to."""
    import tpucfn_torch.ops.attention as ops

    calls = []
    real = ops.dot_product_attention

    def dense(*a, **kw):
        calls.append(("dense", kw.get("mask") is not None))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "dot_product_attention", dense)
    real_policy = auto.should_use_flash

    def policy(*a, **kw):
        calls.append(("policy", kw.get("device")))
        return real_policy(*a, **kw)

    monkeypatch.setattr(auto, "should_use_flash", policy)
    return calls


def _tiny_model():
    from tpucfn_torch.models.llama import Llama, LlamaConfig, \
        init_llama_params

    cfg = LlamaConfig.tiny()
    params = init_llama_params(cfg, generator=torch.Generator().manual_seed(0))
    return cfg, Llama.from_state_dict(cfg, params)


def test_llama_default_resolves_through_the_policy(monkeypatch):
    calls = _spy(monkeypatch)
    cfg, model = _tiny_model()
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 16)))
    model(tokens)
    # every layer asked the policy (with the CPU device), which said dense
    assert calls == [("policy", torch.device("cpu")), ("dense", False)] \
        * cfg.n_layers


def test_llama_packed_attention_resolves_through_the_policy(monkeypatch):
    calls = _spy(monkeypatch)
    cfg, model = _tiny_model()
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 16)))
    segments = torch.tensor([[1] * 8 + [2] * 8, [1] * 16])
    model(tokens, segment_ids=segments)
    assert calls == [("policy", torch.device("cpu")), ("dense", True)] \
        * cfg.n_layers


def test_flash_chosen_on_the_card_goes_to_the_kernels(monkeypatch):
    """With the policy saying flash, the Llama default and the packed
    attention call the kernels' Function (its plain version here)."""
    import tpucfn_torch.kernels.flash_attention as fa

    monkeypatch.setattr(auto, "should_use_flash", lambda *a, **kw: True)
    seen = []
    real = fa.flash_attention

    def flash(*a, **kw):
        seen.append("segment_ids" in kw)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", flash)
    cfg, model = _tiny_model()
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 16)))
    model(tokens)
    model(tokens, segment_ids=torch.ones_like(tokens))
    assert seen == [False] * cfg.n_layers + [True] * cfg.n_layers
