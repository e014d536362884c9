"""chip_smoke.py: its refusals on the CPU, and every phase at tiny sizes.

The phases run here on the CPU at shrunken shapes, so their control flow
and checks are covered; ``gpu``-marked tests run them at the published
widths on a card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402

# Shrunken shapes.  The word-gradient stream B*W (768) stays above the
# vocabulary (512), as it does at the published widths, so the collective
# budget of the mesh phase keeps its meaning.
TINY = cs.Sizes(
    num_words=512, word_dim=16, entity_dim=12, batch=128, window=6,
    negatives=3, train_docs=256, doc_len=12, host_docs=64,
    ref_entities=128, ref_steps=2, sweep_rows=37, num_queries=4, top_k=10,
    cli_docs=16, cli_batch=16,
)
# On the CPU the "card" and the host are one device, so f32 runs agree
# exactly.  bf16 errors are larger than at the published widths: a batch of
# 128 averages far fewer rounding errors into each gradient element.
TINY_TOL = dict(cs.TOL, bf16={"cost": 1e-3, "moment": 0.2, "update": 0.3})


def _run_script(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_refuses_cpu():
    r = _run_script(
        [os.path.join(_REPO, "chip_smoke.py")], _REPO,
        {"JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(["chip_smoke.py"], str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_keeps_cpu_backend(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    cs._keep_cpu_backend()
    assert os.environ["JAX_PLATFORMS"] == "cuda,cpu"
    cs._keep_cpu_backend()
    assert os.environ["JAX_PLATFORMS"] == "cuda,cpu"


def test_phase_train_and_query():
    params = cs.phase_train(TINY)
    assert params.entity_reprs.shape == (TINY.train_docs, TINY.entity_dim)
    cs.phase_query(TINY, params)


def test_phase_reference():
    cs.phase_reference(TINY, tol=TINY_TOL)


def test_phase_reference_catches_a_wrong_step(monkeypatch):
    """A step that drops the entity table's update fails the comparison."""
    import jax.numpy as jnp

    from cunvsm.train import step as step_mod

    real = step_mod.make_train_step

    def broken(desc, cfg, *args, **kwargs):
        inner = real(desc, cfg, *args, **kwargs)
        if cfg.stream_dtype != "bfloat16":
            return inner

        def step(params, opt_state, batch, key):
            kept = jnp.copy(params.entity_reprs)  # params are donated
            new_p, new_o, cost = inner(params, opt_state, batch, key)
            return new_p._replace(entity_reprs=kept), new_o, cost

        return step

    monkeypatch.setattr(step_mod, "make_train_step", broken)
    with pytest.raises(cs.PhaseError, match="entity_reprs update"):
        cs.phase_reference(TINY, tol=TINY_TOL)


@pytest.mark.parametrize("rows", [1, 37, 1023])
def test_phase_sweep(rows):
    import dataclasses

    cs.phase_sweep(dataclasses.replace(TINY, sweep_rows=rows), iters=2)


def test_check_topk_band():
    ref = np.linspace(1.0, 0.0, 50)
    ids = np.arange(5)
    err, overlap = cs.check_topk(ids, ref[ids], ref, 5, 1e-3)
    assert err == 0.0 and overlap == 1.0
    # Dropping a clear winner for a clear loser fails.
    with pytest.raises(cs.PhaseError):
        cs.check_topk(np.array([1, 2, 3, 4, 40]), ref[[1, 2, 3, 4, 40]],
                      ref, 5, 1e-3)


def test_phase_checkpoint(tmp_path):
    assert cs.phase_checkpoint(TINY, str(tmp_path)) is True


def test_phase_four_cards():
    cs.phase_four_cards(TINY)


@pytest.mark.gpu
def test_reference_on_card():
    cs.phase_reference(cs.Sizes())


@pytest.mark.gpu
def test_sweep_on_card():
    cs.phase_sweep(cs.Sizes())


@pytest.mark.gpu
def test_query_on_card():
    import jax

    from cunvsm.models.params import init_params

    s = cs.Sizes()
    desc, _ = cs.nvsm_preset(s)
    params = init_params(
        jax.random.PRNGKey(0), s.num_words, s.train_docs, desc
    )
    cs.phase_query(s, params)
