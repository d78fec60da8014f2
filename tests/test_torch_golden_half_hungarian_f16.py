"""The f16 half Hungarian and half fleet goldens: the checks of tests/
test_torch_golden_half_hungarian.py (its docstring says what each holds)
on the f16 files, in a file of their own so that ``--dist loadfile`` puts
them on another worker."""

import pytest

from test_torch_golden import one_intra_op_thread  # noqa: F401
from test_torch_golden_half_hungarian import CASES, check_jax_recomputes, check_port_reproduces

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("case", CASES)
def test_half_hungarian_goldens_are_what_the_jax_package_computes(case):
    check_jax_recomputes("f16", case)


@pytest.mark.parametrize("case", CASES)
def test_port_plain_path_reproduces_half_hungarian_goldens(case):
    check_port_reproduces("f16", case)
