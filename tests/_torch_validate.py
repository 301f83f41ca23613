"""The port's zero-findings guard, the counterpart of ``tests/conftest.py``'s
``_no_validate_findings`` (which reads the JAX package's counter).  With
``PADDLE_TPU_VALIDATE=warn`` suite-wide, any warning- or error-severity
finding the port's ``Executor`` validate pass records during a test fails
that test (info-severity hazards do not count).  A test that runs a
defective program on purpose opts out with
``@pytest.mark.allow_validate_findings``.  Each ``tests/test_torch_*.py``
imports the fixture, which makes it autouse in that module::

    from _torch_validate import _no_port_validate_findings  # noqa: F401
"""
import pytest


@pytest.fixture(autouse=True)
def _no_port_validate_findings(request):
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.telemetry import REGISTRY

    counter = REGISTRY.counter("validate_findings", scope="analysis")
    before = counter.value
    yield
    if request.node.get_closest_marker("allow_validate_findings"):
        return
    delta = counter.value - before
    if delta:
        recent = "\n  ".join(d.format() for d in analysis.LAST_FINDINGS[-delta:])
        pytest.fail(f"the port's program verifier flagged {delta} finding(s) on programs "
                    f"this test built (false positives: fix the checker or the "
                    f"program):\n  {recent}")
