"""The port's SD-1.5 UNet against the JAX package's, on the CPU: the same
numpy inputs, the JAX parameters carried across by
``unet_params_from_flax``, the tiny config in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.models import unet as junet
from tpucfn_torch.models import UNet, UNetConfig, ddpm_loss
from tpucfn_torch.models import unet as tunet
from tpucfn_torch.models.convert import unet_params_from_flax

# fp32 on both sides; what differs is the order of sums in the
# convolutions, the norms and attention over a few layers.
FWD_TOL = 2e-5
GRAD_TOL = 1e-4  # relative to each gradient's largest entry


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b=2, hw=16, ctx_len=8, seed=0):
    rs = np.random.RandomState(seed)
    return {"latents": rs.randn(b, hw, hw, cfg.in_channels).astype(np.float32),
            "context": rs.randn(b, ctx_len, cfg.context_dim).astype(np.float32)}


def _perturbed(params, seed=1, scale=0.05):
    """Random params with the zero-initialised output convolution made
    nonzero, so the output depends on the whole network."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rs.randn(*a.shape)
                        .astype(np.float32), params)


@pytest.fixture(scope="module")
def tiny():
    cfg = junet.UNetConfig.tiny()
    batch = _batch(cfg)
    model = junet.UNet(cfg)
    params = model.init(jax.random.key(0), batch["latents"],
                        jnp.array([0, 1]), batch["context"])["params"]
    return cfg, model, _perturbed(_np_tree(params)), batch


def _torch_unet(params):
    sd = unet_params_from_flax(params, UNetConfig.tiny())
    return UNet.from_state_dict(UNetConfig.tiny(), sd)


def test_configs_match_the_reference():
    for name in ("sd15", "tiny"):
        j, t = getattr(junet.UNetConfig, name)(), getattr(UNetConfig, name)()
        for field in ("in_channels", "out_channels", "base_width",
                      "blocks_per_stage", "n_heads", "context_dim", "groups"):
            assert getattr(j, field) == getattr(t, field), (name, field)
        assert tuple(j.width_mults) == tuple(t.width_mults)
        assert tuple(j.attn_stages) == tuple(t.attn_stages)
        assert str(jnp.dtype(j.dtype)) == str(t.dtype).split(".")[-1]


def test_timestep_embedding_matches():
    """cos and sin of t * freq: the frequencies may differ by an ulp
    between the two exps, and at t = 999 the argument's fp32 spacing is
    6.1e-5, so the values agree to a few of those."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 320):
        want = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
        got = tunet.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
        np.testing.assert_allclose(got[:3], want[:3], atol=2e-6, rtol=0)


def test_resblock_matches(tiny):
    cfg, _, _, _ = tiny
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 32).astype(np.float32)
    temb = rs.randn(2, 128).astype(np.float32)
    block = junet.ResBlock(64, cfg)
    params = _perturbed(_np_tree(block.init(jax.random.key(1), x, temb)
                                 ["params"]))
    want = np.asarray(block.apply({"params": params}, x, temb))
    tcfg = UNetConfig.tiny()
    port = tunet.ResBlock(32, 64, 128, tcfg)
    port.load_state_dict({n: torch.from_numpy(np.ascontiguousarray(a))
                          for n, a in (_layout(k, v) for k, v in
                                       _flat(params))})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
               torch.from_numpy(temb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)


def _flat(tree, prefix=""):
    from tpucfn_torch.models.convert import _leaves

    return list(_leaves(tree, prefix))


def _layout(name, arr):
    from tpucfn_torch.models.convert import _port_layout

    return _port_layout(name, arr)


def test_spatial_transformer_matches(tiny):
    cfg, _, _, _ = tiny
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 32).astype(np.float32)
    ctx = rs.randn(2, 8, cfg.context_dim).astype(np.float32)
    block = junet.SpatialTransformer(cfg)
    params = _perturbed(_np_tree(block.init(jax.random.key(2), x, ctx)
                                 ["params"]))
    want = np.asarray(block.apply({"params": params}, x, ctx))
    port = tunet.SpatialTransformer(32, UNetConfig.tiny())
    port.load_state_dict({n: torch.from_numpy(np.ascontiguousarray(a))
                          for n, a in (_layout(k, v) for k, v in
                                       _flat(params))})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
               torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_forward_matches(tiny):
    cfg, model, params, batch = tiny
    t = np.array([3, 700], np.int32)
    want = np.asarray(model.apply({"params": params}, batch["latents"],
                                  jnp.asarray(t), batch["context"]))
    got = _torch_unet(params)(torch.from_numpy(batch["latents"]),
                              torch.from_numpy(t),
                              torch.from_numpy(batch["context"]))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def test_zero_init_output():
    """As the reference's test: the zero-initialised output convolution
    makes eps 0 at init."""
    cfg = UNetConfig.tiny()
    g = torch.Generator().manual_seed(0)
    model = UNet.from_state_dict(cfg, tunet.init_unet_params(cfg,
                                                             generator=g))
    batch = _batch(cfg)
    eps = model(torch.from_numpy(batch["latents"]), torch.tensor([0, 1]),
                torch.from_numpy(batch["context"]))
    assert eps.shape == (2, 16, 16, 4)
    assert float(eps.abs().max()) == 0.0


def test_ddpm_loss_and_grads_match(tiny):
    """The reference's own draws of t and the noise (``jax.random.split``,
    ``randint``, ``normal`` as in ``ddpm_loss``) fed to the port's
    ``ddpm_loss_from``: the loss and every gradient agree."""
    cfg, model, params, batch = tiny
    rng = jax.random.key(7)
    t_rng, n_rng = jax.random.split(rng)
    b = batch["latents"].shape[0]
    t = np.asarray(jax.random.randint(t_rng, (b,), 0, 1000))
    noise = np.asarray(jax.random.normal(n_rng, batch["latents"].shape,
                                         jnp.float32))
    want, jgrads = jax.value_and_grad(
        lambda p: junet.ddpm_loss(model, p, batch, rng))(params)
    sd = unet_params_from_flax(params, UNetConfig.tiny())
    sd = {n: torch.nn.Parameter(v) for n, v in sd.items()}
    port = UNet.from_state_dict(UNetConfig.tiny(), sd, trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tunet.ddpm_loss_from(port, tb, torch.from_numpy(t).long(),
                                torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    want_g = unet_params_from_flax(_np_tree(jgrads), UNetConfig.tiny())
    assert set(want_g) == set(sd)
    for name, g in want_g.items():
        scale = max(float(g.abs().max()), 1e-6)
        err = float((sd[name].grad - g).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_ddpm_loss_draws_from_the_generator():
    """``ddpm_loss`` takes t and the noise from the generator it is handed:
    the same seed gives the same loss, another seed another."""
    cfg = UNetConfig.tiny()
    model = UNet.from_state_dict(cfg, tunet.init_unet_params(
        cfg, generator=torch.Generator().manual_seed(0)))
    with torch.no_grad():
        model.conv_out.weight.normal_(0, 0.02,
                                      generator=torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss = lambda s: float(ddpm_loss(  # noqa: E731
        model, batch, torch.Generator().manual_seed(s)))
    assert loss(5) == loss(5) != loss(6)


@pytest.mark.parametrize("name", ["sd15", "tiny"])
def test_param_count_equals_the_reference(name):
    """The port's parameters, counted on the meta device, against
    ``jax.eval_shape`` of the reference's init, exactly."""
    jcfg = getattr(junet.UNetConfig, name)()
    hw, ctx = 16, 8
    shapes = jax.eval_shape(lambda: junet.UNet(jcfg).init(
        jax.random.key(0), jnp.zeros((1, hw, hw, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, ctx, jcfg.context_dim)))["params"])
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = UNet(getattr(UNetConfig, name)())
    assert sum(p.numel() for p in model.parameters()) == want
    # and the converter's names cover the tree one to one
    zeros = jax.tree.map(lambda v: np.broadcast_to(np.float32(0), v.shape),
                         shapes)
    leaves = dict(_layout(k, v) for k, v in _flat(zeros))
    assert set(leaves) == set(model.state_dict())


def test_sd15_attention_head_dims():
    """The SD-1.5 UNet's attention stages run at head dims 40, 80 and 160
    (64x64, 32x32, 16x16 and the middle block): the kernels are built for
    all three."""
    from tpucfn_torch.kernels.flash_attention import HEAD_DIMS

    cfg = UNetConfig.sd15()
    dims = {cfg.base_width * m // cfg.n_heads
            for m, a in zip(cfg.width_mults, cfg.attn_stages) if a}
    dims.add(cfg.base_width * cfg.width_mults[-1] // cfg.n_heads)
    assert dims == {40, 80, 160}
    assert [d in HEAD_DIMS for d in sorted(dims)] == [True, True, True]


def test_frozen_bind_leaves_the_callers_flags():
    """A frozen bind (``from_state_dict`` without ``trainable``, through
    ``bind_state_dict``) of parameters that require grad freezes the
    model's own views of them: every flag of the caller's dict stays as it
    was, and the model still shares the caller's storage."""
    cfg = UNetConfig.tiny()
    params = {k: torch.nn.Parameter(v) for k, v in tunet.init_unet_params(
        cfg, generator=torch.Generator().manual_seed(0)).items()}
    frozen = sorted(params)[0]
    params[frozen].requires_grad_(False)  # a mixed dict: each flag kept
    flags = {k: p.requires_grad for k, p in params.items()}
    model = UNet.from_state_dict(cfg, params)
    assert {k: p.requires_grad for k, p in params.items()} == flags
    assert not any(p.requires_grad for p in model.parameters())
    bound = model.state_dict(keep_vars=True)
    assert set(bound) == set(params)
    assert all(bound[k].data_ptr() == p.data_ptr() for k, p in params.items())
    with torch.no_grad():
        params[frozen].add_(1.0)  # an update in place shows in the model
    assert torch.equal(bound[frozen], params[frozen])


def test_ddpm_training_learns():
    """As the reference's test: the tiny UNet on one batch of 8, AdamW at
    1e-3, through the Trainer; from the zero-initialised output the loss
    (E|eps|^2 ~ 1) falls below its first in 10 steps."""
    from tpucfn_torch.train import Trainer, adamw

    cfg = UNetConfig.tiny()

    def init_fn(g):
        return tunet.init_unet_params(cfg, generator=g), {}

    def loss_fn(params, mstate, batch, g):
        model = UNet.from_state_dict(cfg, params, trainable=True)
        return ddpm_loss(model, batch, g), ({}, mstate)

    trainer = Trainer(None, None, loss_fn, adamw(1e-3), init_fn, device="cpu")
    state = trainer.init(0)
    batch = _batch(cfg, b=8)
    losses = []
    for _ in range(10):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.fixture
def no_group():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_example_tiny_on_cpu(tmp_path, no_group):
    """``tpucfn_torch/examples/sd15_unet.py --tiny`` through
    ``run_train_loop`` on the CPU, on one repeated batch: finite losses
    that fall below the first, the EMA in the checkpointed state."""
    import contextlib
    import io
    import json

    from tpucfn_torch.examples import sd15_unet

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sd15_unet.main(["--device", "cpu", "--tiny", "--batch-size", "2",
                             "--num-examples", "2", "--steps", "6",
                             "--lr", "1e-3", "--log-every", "1",
                             "--run-dir", str(tmp_path)])
    assert rc == 0
    assert "final: step=6" in out.getvalue()
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "train-host000.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_example_refuses_sharded_parameters(tmp_path):
    from tpucfn_torch.examples import sd15_unet

    with pytest.raises(SystemExit, match="ROADMAP Queue 1 C2b"):
        sd15_unet.main(["--device", "cpu", "--tiny", "--fsdp", "2",
                        "--run-dir", str(tmp_path)])
