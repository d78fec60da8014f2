"""The f16 perception front ends' goldens: the checks of tests/
test_torch_golden_half_pointlist.py (its docstring says what each holds)
on the f16 files, in a file of their own so that ``--dist loadfile`` puts
them on another worker."""

import pytest

from test_torch_golden import one_intra_op_thread  # noqa: F401
from test_torch_golden_half_pointlist import (
    FRONT_ENDS,
    check_cli_golden,
    check_jax_recomputes,
    check_port_reproduces,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("case", [f"f16_{c}" for c in FRONT_ENDS])
def test_half_pointlist_goldens_are_what_the_jax_package_computes(case):
    check_jax_recomputes(case)


@pytest.mark.parametrize("case", [f"f16_{c}" for c in FRONT_ENDS])
def test_port_plain_path_reproduces_half_pointlist_goldens(case):
    check_port_reproduces(case)


def test_half_pointlist_cli_golden():
    check_cli_golden("cli_f16_default")
