"""YOLOS and OWL-ViT with the int8 knobs on, against the JAX package's modules
(the checks and tolerances of tests/test_torch_int8_models.py)."""

import pytest

from tests.test_torch_int8_models import KNOB_SETS, check_family, check_family_under_policy


@pytest.mark.parametrize("knobs", list(KNOB_SETS))
@pytest.mark.parametrize("family", ["yolos", "owlvit"])
def test_family_under_int8_matches_jax(monkeypatch, capsys, family, knobs):
    check_family(monkeypatch, capsys, family, knobs)


def test_family_under_int8_and_a_bf16_policy_matches_jax(monkeypatch, capsys):
    check_family_under_policy(monkeypatch, capsys, "yolos", "mixed")
