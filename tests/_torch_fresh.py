"""Fresh default programs, global scope and name counters of the PORT for
each test (``tests/conftest.py``'s ``fresh_programs`` resets the JAX
package's only).  A ``tests/test_torch_*.py`` that builds on the port's
default programs imports the fixture, which makes it autouse there::

    from _torch_fresh import _fresh_port_programs  # noqa: F401
"""
import pytest


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    from paddle_tpu_torch.core import framework, scope, unique_name

    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    scope._global_scope = scope.Scope()
    unique_name.generator.ids.clear()
    yield
