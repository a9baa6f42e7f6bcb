"""The port's checkpoint manager: the JAX package's semantics on
``torch.distributed.checkpoint``.

A save/restore round trip of a ``TrainState`` is bit-exact (params, the
AdamW moments, step counts and update count, the step, the EMA, the step
generator), and the restored state steps exactly as the saved one does;
interval gating as Orbax applies it; idempotent saves; ``max_to_keep``;
the blacklist from ``TPUCFN_CKPT_BLACKLIST``; an unfinalized temp dir
never counts; the stale sweep spares a fresh temp dir; a truncated latest
step raises ``RestoreFailure`` from ``init_or_resume``.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from tpucfn.ft.policy import CKPT_BLACKLIST_ENV as JAX_BLACKLIST_ENV
from tpucfn.ft.policy import RESTORE_FAILED_RC as JAX_RC
from tpucfn.ft.policy import parse_ckpt_blacklist as jax_parse
from tpucfn_torch.ckpt import CheckpointManager
from tpucfn_torch.ft import (CKPT_BLACKLIST_ENV, RESTORE_FAILED_RC,
                             parse_ckpt_blacklist)
from tpucfn_torch.models.llama import LlamaConfig
from tpucfn_torch.obs.trace import Tracer, read_trace_file
from tpucfn_torch.train import (RestoreFailure, Trainer, TrainerConfig,
                                adamw, chain, clip_by_global_norm,
                                llama_train_fns,
                                warmup_cosine_decay_schedule)

torch.set_num_threads(1)


def _trainer(ema_decay=0.9):
    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)
    init_fn, loss_fn = llama_train_fns(cfg, chunk_size=16)
    tx = chain(clip_by_global_norm(1.0), adamw(
        warmup_cosine_decay_schedule(0.0, 1e-3, 2, 20)))
    return Trainer(None, None, loss_fn, tx, init_fn,
                   TrainerConfig(ema_decay=ema_decay), device="cpu")


def _batch(seed):
    return {"tokens": np.random.RandomState(seed).randint(
        0, 256, (4, 24)).astype(np.int32)}


def _trained(steps=3):
    trainer = _trainer()
    state = trainer.init(0)
    for i in range(steps):
        state, _ = trainer.step(state, _batch(i))
    return trainer, state


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def test_constants_and_blacklist_parse_are_jax_s():
    assert (RESTORE_FAILED_RC, CKPT_BLACKLIST_ENV) == (JAX_RC,
                                                       JAX_BLACKLIST_ENV)
    for v in ("", None, "3", "3, 7,x,,9", " 12 "):
        assert parse_ckpt_blacklist(v) == jax_parse(v)


@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_is_bit_exact(tmp_path, async_save):
    trainer, state = _trained()
    trace = tmp_path / "trace.jsonl"
    tracer = Tracer(trace)
    with CheckpointManager(tmp_path / "ckpt", async_save=async_save,
                           tracer=tracer) as ckpt:
        assert ckpt.save(state.step, state)
    names = state.state_dict()
    assert {"step", "generator"} <= set(names)
    assert any(k.startswith("model_state/ema/") for k in names)
    assert any(k.endswith("exp_avg_sq/lm_head.weight") for k in names)
    assert "opt/1/count" in names
    # a fresh trainer from another seed, restored
    other = _trainer()
    restored, step = other.init_or_resume(
        5, CheckpointManager(tmp_path / "ckpt", tracer=tracer))
    assert step == state.step == restored.step == 3
    assert restored.opt_state[1]["count"] == 3
    _assert_same_state(restored, state)
    # and they go on identically
    for i in range(3, 5):
        state, m1 = trainer.step(state, _batch(i))
        restored, m2 = other.step(restored, _batch(i))
        assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(restored, state)
    tracer.close()
    spans = {r["name"]: r for r in read_trace_file(trace)}
    assert spans["ckpt_write"]["attrs"]["bytes"] > 0
    assert spans["ckpt_restore"]["trace_id"] == 3


def test_interval_gating_and_idempotent_saves(tmp_path):
    _, state = _trained(1)
    ckpt = CheckpointManager(tmp_path, save_interval_steps=3, max_to_keep=10,
                             async_save=False)
    # Orbax's rule: the first save of a directory always runs
    saved = [s for s in range(1, 8) if ckpt.save(s, state)]
    assert saved == [1, 3, 6]
    assert not ckpt.save(6, state) and not ckpt.save(6, state, force=True)
    assert not ckpt.save(5, state)  # not past the latest
    assert ckpt.save(7, state, force=True)
    assert ckpt.all_steps() == [1, 3, 6, 7]
    # a relaunch's manager sees the steps: no initial save again
    again = CheckpointManager(tmp_path, save_interval_steps=3,
                              async_save=False)
    assert not again.save(8, state) and again.save(9, state)


def test_max_to_keep_drops_the_oldest(tmp_path):
    _, state = _trained(1)
    with CheckpointManager(tmp_path, max_to_keep=2) as ckpt:
        for s in (1, 2, 3, 4):
            assert ckpt.save(s, state)
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4]


def test_blacklist_from_the_env_steers_latest(tmp_path, monkeypatch):
    _, state = _trained(1)
    with CheckpointManager(tmp_path, async_save=False) as ckpt:
        for s in (1, 2, 3):
            ckpt.save(s, state)
    monkeypatch.setenv(CKPT_BLACKLIST_ENV, "3,2")
    ckpt = CheckpointManager(tmp_path)
    assert ckpt.blacklist_steps == {2, 3}
    assert ckpt.latest_step() == 1
    ckpt.restore(_trainer().init(1), step=3)  # named: honored


def test_unfinalized_temp_dir_never_counts(tmp_path):
    _, state = _trained(2)
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(2, state)
    tmp = tmp_path / "5.ckpt-tmp-123-456"
    tmp.mkdir()
    (tmp / "__0_0.distcp").write_bytes(b"partial")
    assert ckpt.all_steps() == [2] and ckpt.latest_step() == 2
    restored, step = _trainer().init_or_resume(0, ckpt)
    assert step == 2 and restored.step == 2


def test_stale_sweep_spares_a_fresh_temp_dir(tmp_path):
    fresh, stale = tmp_path / "4.ckpt-tmp-1-1", tmp_path / "3.ckpt-tmp-1-0"
    for d in (fresh, stale):
        d.mkdir()
        (d / "__0_0.distcp").write_bytes(b"x")
    old = time.time() - 120
    for p in (stale / "__0_0.distcp", stale):
        os.utime(p, (old, old))
    CheckpointManager(tmp_path)
    assert fresh.exists() and not stale.exists()


def test_truncated_latest_step_raises_restore_failure(tmp_path):
    trainer, state = _trained(1)
    with CheckpointManager(tmp_path, async_save=False) as ckpt:
        ckpt.save(1, state)
        state, _ = trainer.step(state, _batch(1))
        ckpt.save(2, state)
    biggest = max((tmp_path / "2").glob("*.distcp"),
                  key=lambda p: p.stat().st_size)
    biggest.write_bytes(biggest.read_bytes()[:100])
    with pytest.raises(RestoreFailure, match="step 2") as e:
        _trainer().init_or_resume(0, CheckpointManager(tmp_path))
    assert e.value.step == 2
    # the blacklist (what the coordinator sets next) resumes from step 1
    restored, step = _trainer().init_or_resume(
        0, CheckpointManager(tmp_path, blacklist_steps=[2]))
    assert step == 1 and restored.step == 1


def test_fresh_ignores_checkpoints(tmp_path):
    _, state = _trained(1)
    with CheckpointManager(tmp_path) as ckpt:
        ckpt.save(1, state)
    fresh, step = _trainer().init_or_resume(0, CheckpointManager(tmp_path),
                                            fresh=True)
    assert step is None and fresh.step == 0


def test_a_failed_async_save_raises_on_wait(tmp_path, monkeypatch):
    _, state = _trained(1)
    ckpt = CheckpointManager(tmp_path)
    import torch.distributed.checkpoint as dcp

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(dcp, "save", broken)
    assert ckpt.save(1, state)
    with pytest.raises(RuntimeError, match="save failed"):
        ckpt.wait()
    assert ckpt.all_steps() == [] and not list(tmp_path.iterdir())
