"""The port's version metadata and availability gates against the JAX
package's (``metrics_tpu/__about__.py``, ``utilities/imports.py``)."""
import operator

import pytest

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.utilities import imports as jimports
from metrics_tpu_torch.utilities import imports as timports


def test_the_version_metadata_is_the_jax_package_s():
    from metrics_tpu import __about__ as jabout
    from metrics_tpu_torch import __about__ as tabout

    assert metrics_tpu_torch.__version__ == metrics_tpu.__version__ == tabout.__version__
    assert (tabout.__author__, tabout.__license__) == (jabout.__author__, jabout.__license__)


@pytest.mark.parametrize("module", ["numpy", "numpy.linalg", "torch", "scipy", "no_such_module", "numpy.no_such",
                                    "", "torch.distributed.tensor"])
def test_module_available_equals_the_jax_package(module):
    assert timports._module_available(module) == jimports._module_available(module)


@pytest.mark.parametrize("op", [operator.ge, operator.lt, operator.eq])
@pytest.mark.parametrize("package,version", [("numpy", "1.0"), ("numpy", "99.0"), ("torch", "2.0.0"),
                                             ("no_such_module", "1.0")])
def test_compare_version_equals_the_jax_package(op, package, version):
    assert timports._compare_version(package, op, version) == jimports._compare_version(package, op, version)


def test_the_gates_say_what_is_installed():
    assert timports._compare_version("torch", operator.ge, "2.0.0")
    assert timports._module_available("scipy") == jimports._SCIPY_AVAILABLE
    assert timports._release("2.13.0+cpu") == (2, 13, 0) and timports._release("nightly") == (0,)
