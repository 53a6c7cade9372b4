"""A cyclic (IVC) hash chain: each proof hashes the previous proof's latest
hash once and verifies that proof, a proof of this same circuit, or a dummy
in the base case (reference: plonky2/src/recursion/cyclic_recursion.rs
test_cyclic_recursion, 295-395).

Public inputs: the initial hash (4), the latest hash (4), the counter of
hashes applied, then the circuit's own verifier data (the constants/sigmas
cap and the circuit digest).

    data, chain = hash_chain_circuit()
    proof = prove_step(data, chain, None, [0, 1, 2, 3])   # base case
    proof = prove_step(data, chain, proof)                # one step more
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.proof_target import add_virtual_proof_with_pis, set_proof_with_pis_target
from ..plonk.prover import prove
from ..plonk.recursive_verifier import set_verifier_data_target
from ..recursion.conditional import DummyProofGenerator
from ..recursion.cyclic_recursion import (
    common_data_for_recursion,
    conditionally_verify_cyclic_proof_or_dummy,
    cyclic_base_proof,
    register_verifier_data_public_inputs,
)


@dataclasses.dataclass
class HashChain:
    common_data: object  # the common data the circuit verifies proofs of
    condition: object  # BoolTarget: 1 verifies the inner proof, 0 a dummy
    inner: object  # ProofWithPublicInputsTarget
    verifier_data: object  # VerifierCircuitTarget (the public inputs)
    device: object


def hash_chain_circuit(config: Optional[CircuitConfig] = None, common_data=None,
                       commit: bool = True, device=None):
    """Returns (circuit data, HashChain). common_data: the recursion shape
    the circuit must have (default ``common_data_for_recursion(config)``).
    device: where the commitment and the dummy proofs live; None means the
    GPU (raises without one)."""
    config = config or CircuitConfig.standard_recursion_config()
    if common_data is None:
        common_data = common_data_for_recursion(config)
    b = CircuitBuilder(config)
    one = b.constant(1)
    initial_hash = b.add_virtual_targets(4)
    b.register_public_inputs(initial_hash)
    current_hash_in = b.add_virtual_targets(4)
    b.register_public_inputs(b.hash_n_to_hash_no_pad(list(current_hash_in)))
    counter = b.add_virtual_public_input()
    vd_t = register_verifier_data_public_inputs(b, common_data.fri_params.config.cap_height)
    common_data = dataclasses.replace(common_data, num_public_inputs=len(b.public_inputs))

    condition = b.add_virtual_bool_target_safe()
    inner = add_virtual_proof_with_pis(b, common_data)
    inner_pis = inner.public_inputs
    for a, c in zip(initial_hash, inner_pis[0:4]):
        b.connect(a, c)
    actual_in = [b.select(condition, x, y) for x, y in zip(inner_pis[4:8], initial_hash)]
    for a, c in zip(current_hash_in, actual_in):
        b.connect(a, c)
    b.connect(counter, b.mul_add(condition.target, inner_pis[8], one))
    conditionally_verify_cyclic_proof_or_dummy(b, condition, inner, common_data, device=device)
    data = b.build(commit=commit, device=device)
    return data, HashChain(common_data, condition, inner, vd_t, device)


def prove_step(data, chain: HashChain, previous=None,
               initial_hash: Optional[List[int]] = None):
    """The next proof of the chain: over ``previous`` (a proof of this
    circuit), or the base case over a dummy proof that carries
    ``initial_hash`` when ``previous`` is None. The base case proves the
    dummy circuit that the circuit's DummyProofGenerator builds and keeps,
    so one dummy circuit serves both."""
    pw = PartialWitness()
    if previous is None:
        pw.set_target(chain.condition.target, 0)
        dummy_gen = next(
            g for g in data.prover_only.generators if isinstance(g, DummyProofGenerator)
        )
        previous = cyclic_base_proof(
            dummy_gen.circuit(), data.verifier_only, dict(enumerate(initial_hash)),
            device=chain.device,
        )
    else:
        pw.set_target(chain.condition.target, 1)
    set_proof_with_pis_target(pw, chain.inner, previous)
    set_verifier_data_target(pw, chain.verifier_data, data.verifier_only)
    return prove(data.prover_only, data.common, pw, device=chain.device)
