"""The learning mode and ``tune`` under f16: the checks of tests/
test_torch_half_learning.py (its docstring says what each holds) on f16,
in a file of their own so that ``--dist loadfile`` puts them on another
worker."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import one_intra_op_thread  # noqa: E402, F401
from test_torch_half_learning import (  # noqa: E402
    check_f11, check_golden_recomputes, check_node_windows, check_port_reproduces_golden,
    check_port_tune_reproduces, check_scenario, check_tune_golden_recomputes,
    check_tune_windows)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

HTAG = "f16"


def test_velocity_windows_are_the_jax_node_windows():
    check_node_windows(HTAG)


def test_velocity_windows_are_the_jax_tune_windows(tmp_path):
    check_tune_windows(HTAG, tmp_path)


def test_f11_tune_under_a_half_dtype_prints_the_jax_lines(tmp_path):
    check_f11(HTAG, tmp_path)


@pytest.mark.parametrize("scenario", ["runtime", "growth", "resume"])
def test_half_learning_node_is_the_jax_node(scenario, tmp_path):
    check_scenario(HTAG, scenario, tmp_path)


def test_half_learning_golden_is_what_the_jax_package_computes():
    check_golden_recomputes(HTAG)


def test_port_node_reproduces_half_learning_golden():
    check_port_reproduces_golden(HTAG)


def test_half_tune_golden_is_what_the_jax_cli_prints():
    check_tune_golden_recomputes(HTAG)


def test_port_tune_reproduces_half_tune_golden(tmp_path):
    check_port_tune_reproduces(HTAG, tmp_path)
