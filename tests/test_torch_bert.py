"""The port's BERT against the JAX package's, on the CPU: the same numpy
inputs, the JAX parameters carried across by ``bert_params_from_flax``,
the tiny config in fp32; and the port's BERT example through
``run_train_loop``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.models import bert as jbert
from tpucfn_torch.models import Bert, BertConfig, mlm_loss
from tpucfn_torch.models import bert as tbert
from tpucfn_torch.models.convert import bert_params_from_flax

# fp32 on both sides: sum order over two layers only.
FWD_TOL = 2e-5
GRAD_TOL = 1e-4  # relative to each gradient's largest entry
# The key projection's bias gets no gradient in exact arithmetic (the
# softmax ignores a shift that is the same for every key); both sides
# give rounding noise of ~1e-9 there.
GRAD_FLOOR = 1e-7


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = jbert.BertConfig.tiny()
    model = jbert.Bert(cfg)
    params = _np_tree(model.init(jax.random.key(0),
                                 jnp.zeros((1, 16), jnp.int32))["params"])
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    types = rs.randint(0, 2, (3, 16)).astype(np.int32)
    attn = np.ones((3, 16), bool)
    attn[1, 10:] = False  # padding
    attn[2, 5:] = False
    return cfg, model, params, tokens, types, attn


def _port(params):
    cfg = BertConfig.tiny()
    return Bert.from_state_dict(cfg, bert_params_from_flax(params, cfg))


def test_configs_match_the_reference():
    for name in ("base", "tiny"):
        j, t = getattr(jbert.BertConfig, name)(), getattr(BertConfig, name)()
        for field in ("vocab_size", "dim", "n_layers", "n_heads", "ffn_dim",
                      "max_positions", "type_vocab", "dropout", "norm_eps"):
            assert getattr(j, field) == getattr(t, field), (name, field)


def test_forward_with_padding_mask_matches(tiny):
    cfg, model, params, tokens, types, attn = tiny
    want = np.asarray(model.apply({"params": params}, tokens,
                                  token_types=types, attn_mask=attn))
    got = _port(params)(torch.from_numpy(tokens),
                        token_types=torch.from_numpy(types),
                        attn_mask=torch.from_numpy(attn))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def test_padding_mask_isolates_positions(tiny):
    """As the reference's test: outputs at kept positions do not depend on
    the pad tokens' contents."""
    _, _, params, _, _, _ = tiny
    model = _port(params)
    toks = torch.ones((1, 16), dtype=torch.int64)
    mask = torch.tensor([[True] * 8 + [False] * 8])
    a = model(toks, attn_mask=mask)
    toks2 = toks.clone()
    toks2[0, 8:] = 77
    b = model(toks2, attn_mask=mask)
    torch.testing.assert_close(a[0, :8], b[0, :8], atol=1e-5, rtol=0)


def test_mlm_loss_and_grads_match(tiny):
    cfg, model, params, tokens, types, attn = tiny
    rs = np.random.RandomState(1)
    mask = rs.rand(*tokens.shape) < 0.3
    masked = np.where(mask, 3, tokens).astype(np.int32)

    def jloss(p):
        logits = model.apply({"params": p}, masked, attn_mask=attn)
        return jbert.mlm_loss(logits, tokens, mask)

    (want, want_acc), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    sd = {n: torch.nn.Parameter(v) for n, v in
          bert_params_from_flax(params, BertConfig.tiny()).items()}
    port = Bert.from_state_dict(BertConfig.tiny(), sd, trainable=True)
    logits = port(torch.from_numpy(masked), attn_mask=torch.from_numpy(attn))
    loss, acc = mlm_loss(logits, torch.from_numpy(tokens),
                         torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert acc.item() == pytest.approx(float(want_acc), abs=1e-7)
    want_g = bert_params_from_flax(_np_tree(jgrads), BertConfig.tiny())
    assert set(want_g) == set(sd)
    for name, g in want_g.items():
        scale = float(g.abs().max())
        err = float((sd[name].grad - g).abs().max())
        assert err <= max(GRAD_TOL * scale, GRAD_FLOOR), (name, err, scale)


@pytest.mark.parametrize("name", ["base", "tiny"])
def test_param_count_equals_the_reference(name):
    """The port's parameters, counted on the meta device, against
    ``jax.eval_shape`` of the reference's init, exactly."""
    shapes = jax.eval_shape(lambda: jbert.Bert(
        getattr(jbert.BertConfig, name)()).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = Bert(getattr(BertConfig, name)())
    assert sum(p.numel() for p in model.parameters()) == want


def test_mlm_training_learns():
    """As the reference's test: tiny BERT on one masked batch, AdamW at
    3e-3, through the Trainer; the loss falls below 0.8 of its first in
    30 steps."""
    from tpucfn_torch.train import Trainer, adamw

    cfg = BertConfig.tiny()

    def init_fn(g):
        return tbert.init_bert_params(cfg, generator=g), {}

    def loss_fn(params, mstate, batch, g):
        model = Bert.from_state_dict(cfg, params, trainable=True)
        logits = model(batch["masked"])
        loss, acc = mlm_loss(logits, batch["labels"], batch["mask"])
        return loss, ({"accuracy": acc}, mstate)

    trainer = Trainer(None, None, loss_fn, adamw(3e-3), init_fn, device="cpu")
    state = trainer.init(0)
    rs = np.random.RandomState(0)
    labels = rs.randint(5, cfg.vocab_size, (8, 16))
    mask = rs.rand(8, 16) < 0.15
    batch = {"masked": np.where(mask, 3, labels), "labels": labels,
             "mask": mask}
    losses = []
    for _ in range(30):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0], losses


def test_masking_is_80_10_10():
    from tpucfn_torch.examples.bert_base import MASK_ID, mask_tokens

    tokens = torch.full((64, 512), 7, dtype=torch.int64)
    masked, mask = mask_tokens(tokens, torch.Generator().manual_seed(0),
                               0.15, 128)
    frac = mask.float().mean().item()
    assert 0.14 < frac < 0.16
    chosen = masked[mask]
    assert 0.77 < (chosen == MASK_ID).float().mean().item() < 0.83
    assert torch.equal(masked[~mask], tokens[~mask])


@pytest.fixture
def no_group():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_example_tiny_on_cpu(tmp_path, no_group):
    """``tpucfn_torch/examples/bert_base.py --tiny`` through
    ``run_train_loop`` on the CPU: finite losses, the final line."""
    import contextlib
    import io
    import json

    from tpucfn_torch.examples import bert_base

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bert_base.main(["--device", "cpu", "--tiny", "--seq-len", "16",
                             "--batch-size", "8", "--num-examples", "32",
                             "--steps", "4", "--log-every", "1",
                             "--run-dir", str(tmp_path)])
    assert rc == 0
    assert "final: step=4" in out.getvalue()
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "train-host000.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
