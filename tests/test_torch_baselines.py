"""The port's baselines, policy JSON and lowering plans held against the
JAX package's on the same inputs.

* ``core/baselines.py``: ``hadamard_transform``, ``hadamard_qdq`` and
  ``logfmt_qdq`` at bits 2-8, groups 32 and 128, on float32 and bfloat16
  inputs from a numpy seed. Tolerance: ``TOL`` times the input's largest
  magnitude (the JAX functions run eagerly; the worst case measured is
  in ``repro_torch/core/baselines.py``'s docstring).
* ``core/policy.py``: ``policy_to_json`` gives JAX's text for the stock
  policies, and every JSON file round-trips through ``save_policy_file``
  / ``load_policy_file``.
* ``configs/registry.py``: ``lowering_plan`` equals JAX's field for field
  for every ``all_pairs()`` pair; ``INPUT_SHAPES`` and ``param_count``
  equal JAX's.
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import all_pairs as j_all_pairs
from repro.configs import lowering_plan as j_lowering_plan
from repro.core import baselines as jb
from repro.core import policy as jpol
from repro.models.config import INPUT_SHAPES as J_SHAPES
from repro_torch.configs import ARCH_IDS, all_pairs, get_config, \
    lowering_plan
from repro_torch.core import baselines as tb
from repro_torch.core import policy as tpol
from repro_torch.models.config import INPUT_SHAPES

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401

POLICY_DIR = Path(__file__).resolve().parents[1] / "configs" / "policies"
#: |port - JAX| <= TOL * max|x| for every baseline output
TOL = 2.0 ** -20


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def _input(dtype: str, group: int, seed: int = 0):
    """(4, 8 groups) Gaussian rows with an outlier and a zero a row, as
    numpy float32 rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 8 * group)).astype(np.float32)
    x[:, 3] *= 40.0
    x[:, 5] = 0.0
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x


def _pair(x: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


def _worst(j, t, x) -> float:
    return float(np.max(np.abs(_np(j) - _np(t))) / np.max(np.abs(x)))


_CASES = [(g, d) for g in (32, 128) for d in ("float32", "bfloat16")]


def test_hadamard_transform_matches_jax():
    for group, dtype in _CASES:
        x = _input(dtype, group).reshape(-1, group)
        jx, tx = _pair(x, dtype)
        assert _worst(jb.hadamard_transform(jx), tb.hadamard_transform(tx),
                      x) <= TOL, (group, dtype)


@pytest.mark.parametrize("fn", ["hadamard_qdq", "logfmt_qdq"])
def test_baseline_qdq_matches_jax(fn):
    for group, dtype in _CASES:
        x = _input(dtype, group, seed=group)
        jx, tx = _pair(x, dtype)
        for bits in range(2, 9):
            j = getattr(jb, fn)(jx, bits, group)
            t = getattr(tb, fn)(tx, bits, group)
            assert t.dtype == tx.dtype and tuple(t.shape) == x.shape
            assert _worst(j, t, x) <= TOL, (group, dtype, bits)


# ---------------------------------------------------------------------------
# policy JSON
# ---------------------------------------------------------------------------

_STOCK = ("paper_policy", "optimized_policy", "aggressive_policy",
          "depth_policy")


def test_policy_to_json_matches_jax():
    for name in _STOCK + ("BF16_POLICY",):
        j, t = getattr(jpol, name), getattr(tpol, name)
        if name != "BF16_POLICY":
            j, t = j(), t()
        assert tpol.policy_to_json(t) == jpol.policy_to_json(j), name


def test_policy_files_round_trip(tmp_path):
    paths = sorted(POLICY_DIR.glob("*.json"))
    assert len(paths) == 3
    for path in paths:
        pol = tpol.load_policy_file(str(path))
        out = tmp_path / path.name
        tpol.save_policy_file(str(out), pol)
        assert tpol.load_policy_file(str(out)) == pol
        assert out.read_text() == jpol.policy_to_json(
            jpol.load_policy_file(str(path))), path.name


def test_stock_policies_round_trip(tmp_path):
    for name in _STOCK:
        pol = getattr(tpol, name)()
        tpol.save_policy_file(str(tmp_path / "p.json"), pol)
        assert tpol.load_policy_file(str(tmp_path / "p.json")) == pol


# ---------------------------------------------------------------------------
# lowering plans
# ---------------------------------------------------------------------------

def test_lowering_plans_match_jax():
    pairs = list(all_pairs())
    assert sorted(pairs) == sorted(j_all_pairs()) and len(pairs) == 40
    for arch, shape in pairs:
        assert dataclasses.asdict(lowering_plan(arch, shape)) == \
            dataclasses.asdict(j_lowering_plan(arch, shape)), (arch, shape)


def test_input_shapes_and_param_count_match_jax():
    from repro.configs import get_config as j_get_config
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in ARCH_IDS:
        assert get_config(arch).param_count() == \
            j_get_config(arch).param_count(), arch
