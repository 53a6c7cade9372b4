"""The STARK testing harness of the port (plonky2_tpu_torch.stark.stark_testing,
the JAX package's tests/test_stark_harness.py case by case) over every
fixture, on the CPU: the constraint degree bound over the LDE of a random
low-degree trace, evaluated by the device algebra on CPU tensors, and the
host-extension against the in-circuit algebra. A fixture whose constraint
exceeds its declared degree is caught; UnconstrainedStark proves and
verifies."""

import pytest

from _torch_port import lazy_module

st = lazy_module("plonky2_tpu_torch.stark.stark_testing")
tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tfri_config = lazy_module("plonky2_tpu_torch.fri.config")
tprover = lazy_module("plonky2_tpu_torch.stark.prover")
tverifier = lazy_module("plonky2_tpu_torch.stark.verifier")

# the harness's functions are named test_*: reach them as attributes, so
# that pytest does not collect them from this module
FIXTURES = ["FibonacciStark", "PermutationStark", "UnconstrainedStark", "CtlLookingStark",
            "CtlLookedStark"]


@pytest.mark.parametrize("name", FIXTURES)
def test_low_degree(name):
    st.test_stark_low_degree(getattr(tfix, name)(1 << 5), device="cpu")


@pytest.mark.parametrize("name", FIXTURES)
def test_algebra_consistency(name):
    st.test_stark_algebra_consistency(getattr(tfix, name)(1 << 5))


def test_low_degree_catches_an_understated_degree():
    """A FibonacciStark that declares degree 1 while its constraints have
    degree 2 (with the transition selector) fails the bound."""

    class Understated(tfix.FibonacciStark):
        def constraint_degree(self):
            return 1

    with pytest.raises(AssertionError, match="exceeds"):
        st.test_stark_low_degree(Understated(1 << 5), device="cpu")


def test_unconstrained_stark_proves():
    """tests/test_stark_harness.py::test_unconstrained_stark_proves, under
    one PoW bit."""
    stark = tfix.UnconstrainedStark(1 << 5)
    config = tconfig.StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=tfri_config.FriConfig(
            rate_bits=1, cap_height=1, proof_of_work_bits=1,
            reduction_strategy=tfri_config.FriReductionStrategy.ConstantArityBits(1, 2),
            num_query_rounds=8,
        ),
    )
    pwp = tprover.prove(stark, config, stark.generate_trace(7), [], device="cpu")
    tverifier.verify_stark_proof(stark, pwp, config, 5)
