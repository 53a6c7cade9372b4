"""Device-resident Fiat-Shamir challenger: the same overwrite-mode duplex
as hash/challenger.py (core/src/challenger.rs semantics), with the sponge
state and every observed element kept as tensors on the proof's device.

The transcript of a fixed circuit has a static shape (how many elements
are observed, when challenges are squeezed), so all buffer bookkeeping —
inputs pending, outputs left — is host-side Python over tensor slices;
only the permutation is device work. A duplex writes the pending inputs
over the leading lanes of the state (out of place) and permutes it as a
[1, 12] batch: on a CUDA tensor, one launch of the Poseidon permutation
kernel. Nothing here reads a value back to the host, so a whole
transcript runs without waiting for the device (reference:
plonky2_tpu/hash/device_challenger.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops import gf
from ..ops import poseidon as dp
from .poseidon import SPONGE_RATE, SPONGE_WIDTH


@dataclass
class DeviceChallengerState:
    """A transcript handed from one phase to the next without a host read:
    the sponge state [12], the input buffer padded to [RATE] of which the
    first ``in_len`` entries are pending, and the number of outputs left.
    Buffered outputs are always the leading lanes of the state (a duplex
    sets them to state[:RATE], a squeeze pops the last, an observation
    clears them all), so their count carries them."""

    state: torch.Tensor
    input_buffer: torch.Tensor
    in_len: int
    out_len: int = 0

    @staticmethod
    def from_host(challenger, device) -> "DeviceChallengerState":
        """Upload a host challenger's state and pending inputs."""
        inbuf = np.zeros(SPONGE_RATE, dtype=np.uint64)
        in_len = len(challenger.input_buffer)
        inbuf[:in_len] = np.array(challenger.input_buffer, dtype=np.uint64)
        out_len = len(challenger.output_buffer)
        assert list(challenger.output_buffer) == list(challenger.sponge_state[:out_len])
        both = np.concatenate([np.array(challenger.sponge_state, dtype=np.uint64), inbuf])
        t = gf.from_u64(both, device)
        return DeviceChallengerState(t[:SPONGE_WIDTH], t[SPONGE_WIDTH:], in_len, out_len)


class DeviceChallenger:
    def __init__(self, state: torch.Tensor, pending: torch.Tensor = None, out_len: int = 0):
        """state: [12] canonical words; pending: inputs observed but not yet
        duplexed (at most RATE - 1 of them); out_len: outputs left, which
        are state[:out_len] (none while inputs are pending)."""
        assert state.shape == (SPONGE_WIDTH,)
        self.state = state
        self._inputs: List[torch.Tensor] = []
        self._in_len = 0
        self._out_len = out_len  # popped from the end
        if pending is not None and pending.numel():
            assert pending.numel() < SPONGE_RATE and not out_len
            self._inputs.append(pending.reshape(-1))
            self._in_len = pending.numel()

    @staticmethod
    def from_state(st: DeviceChallengerState) -> "DeviceChallenger":
        return DeviceChallenger(st.state, st.input_buffer[: st.in_len], st.out_len)

    @staticmethod
    def from_host(challenger, device) -> "DeviceChallenger":
        return DeviceChallenger.from_state(DeviceChallengerState.from_host(challenger, device))

    @property
    def in_len(self) -> int:
        return self._in_len

    # -- duplex ----------------------------------------------------------------

    def _pending(self) -> torch.Tensor:
        return self._inputs[0] if len(self._inputs) == 1 else torch.cat(self._inputs)

    def overlaid_state(self) -> torch.Tensor:
        """The state with the pending inputs written over its leading lanes:
        what the next duplex permutes (the PoW grind's base state, with the
        witness going to lane ``in_len``)."""
        if not self._in_len:
            return self.state
        return torch.cat([self._pending(), self.state[self._in_len:]])

    def _duplex(self) -> None:
        self.state = dp.permute(self.overlaid_state()[None])[0]
        self._inputs = []
        self._in_len = 0
        self._out_len = SPONGE_RATE

    # -- observations ----------------------------------------------------------

    def observe_elements(self, xs: torch.Tensor) -> None:
        """Observe a vector of canonical words in order, a rate-sized chunk
        at a time (a slice each, never a scalar at a time)."""
        xs = xs.reshape(-1)
        pos, n = 0, xs.shape[0]
        while pos < n:
            self._out_len = 0  # any observation clears buffered outputs
            take = min(SPONGE_RATE - self._in_len, n - pos)
            self._inputs.append(xs[pos : pos + take])
            self._in_len += take
            pos += take
            if self._in_len == SPONGE_RATE:
                self._duplex()

    def observe_cap_rows(self, cap: torch.Tensor) -> None:
        """cap: [m, 4] digests, observed row by row."""
        self.observe_elements(cap)

    # -- challenges ------------------------------------------------------------

    def get_n_challenges(self, n: int) -> torch.Tensor:
        """[n] challenges in the host challenger's order: a duplex first if
        inputs are pending or no outputs are left, then outputs popped from
        the end of the squeeze buffer."""
        parts = []
        while n:
            if self._in_len or not self._out_len:
                self._duplex()
            take = min(n, self._out_len)
            part = self.state[self._out_len - take : self._out_len]
            parts.append(part if take == 1 else part.flip(0))
            self._out_len -= take
            n -= take
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def get_challenge(self) -> torch.Tensor:
        return self.get_n_challenges(1)[0]

    def get_extension_challenge(self) -> torch.Tensor:
        """[2]: (c0, c1)."""
        return self.get_n_challenges(2)

    # -- hand-off --------------------------------------------------------------

    def export(self) -> DeviceChallengerState:
        """Everything a later phase needs to resume this transcript."""
        pad = gf.zeros((SPONGE_RATE - self._in_len,), self.state.device)
        buf = torch.cat(self._inputs + [pad]) if self._in_len else pad
        return DeviceChallengerState(self.state, buf, self._in_len, self._out_len)
