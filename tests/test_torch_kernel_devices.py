"""Every binding launches its kernel on its tensors' card, checked in pure
Python on the CPU (nothing is compiled, no kernel runs):

- each binding's library is a stand-in that records, for every launch,
  the card current at the call and the card of the stream it was given;
- torch.cuda's device state is a stand-in: card 0 current, streams that
  name their card, and CPU tensors that stand for card 1;
- every launch of col_fft (with and without tail stages), row_fft, the
  product and the three Poseidon kernels must run with card 1 current, on
  card 1's stream, and card 0 must be current again after the call;
- csrc/ntt.cu raises the passes' shared-memory limit for the kernel it is
  about to launch, in every pass, and keeps no state between calls (a
  limit raised once a process stays at 48 KB on every other card).

tools/torch_kernel_host_check.py --devices 2 runs the same on the
kernels' own source, over two stand-in devices.
"""

import contextlib
import os
import re
import types

import pytest

from _torch_port import lazy_module

field_cuda = lazy_module("plonky2_tpu_torch.ops.field_cuda")
ntt_cuda = lazy_module("plonky2_tpu_torch.ops.ntt_cuda")
poseidon_cuda = lazy_module("plonky2_tpu_torch.ops.poseidon_cuda")

_NTT_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "plonky2_tpu_torch", "ops", "csrc", "ntt.cu")
CURRENT, TENSORS = 0, 1


class _Cards:
    """torch.cuda's device state: the current card, and streams whose
    handle names their card; a CPU tensor stands for card ``TENSORS``."""

    def __init__(self):
        self.current = CURRENT

    def index(self, d) -> int:
        if d is None:
            return self.current
        if isinstance(d, int):
            return d
        if d.type == "cpu":
            return TENSORS
        return self.current if d.index is None else d.index

    @contextlib.contextmanager
    def device(self, d):
        before, self.current = self.current, self.index(d)
        try:
            yield
        finally:
            self.current = before

    def current_stream(self, d=None):
        return types.SimpleNamespace(cuda_stream=(self.index(d) + 1) << 8)


class _Recorder:
    """A library whose entry points record (entry point, current card, the
    card of the stream, its last argument) and return 0."""

    def __init__(self, cards: _Cards):
        self.cards = cards
        self.launches = []

    def load(self):
        return self

    def __getattr__(self, name):
        if not name.startswith("plonky2_"):
            raise AttributeError(name)

        def entry(*args):
            self.launches.append((name, self.cards.current, (args[-1] >> 8) - 1))
            return 0

        return entry


@pytest.fixture
def cards(monkeypatch):
    import torch

    state = _Cards()
    monkeypatch.setattr(torch.cuda, "device", state.device)
    monkeypatch.setattr(torch.cuda, "current_stream", state.current_stream)
    monkeypatch.setattr(ntt_cuda.load(), "_check", lambda x, what: None)
    monkeypatch.setattr(field_cuda.load(), "_check", lambda x, what: None)
    monkeypatch.setattr(poseidon_cuda.load(), "_check", lambda x, width, what: None)
    lib = _Recorder(state)
    for m in (ntt_cuda, field_cuda, poseidon_cuda):
        monkeypatch.setattr(m.load(), "LIB", lib)
    yield lib
    for m in (ntt_cuda, field_cuda, poseidon_cuda):
        m.reset_launches()


def _zeros(*shape):
    import torch

    return torch.zeros(shape, dtype=torch.int64)


# (case, the wrapper's call, the entry points it must launch)
_CASES = {
    "col_fft": (lambda: ntt_cuda.col_fft(_zeros(2, 1 << 8, 16), 8, 0, True),
                {"plonky2_col_fft_pass"}),
    "col_fft_with_tail": (lambda: ntt_cuda.col_fft(_zeros(3, 1 << 13, 4), 13, 0, False),
                          {"plonky2_col_fft_pass", "plonky2_ntt_stage"}),
    "row_fft": (lambda: ntt_cuda.row_fft(_zeros(2, 1 << 15), 15, 0, False),
                {"plonky2_row_fft_pass"}),
    "gl_mul": (lambda: field_cuda.mul(_zeros(5, 64), _zeros(64)), {"plonky2_gl_mul"}),
    "permute": (lambda: poseidon_cuda.permute(_zeros(5, 12)), {"plonky2_poseidon_permute"}),
    "compress": (lambda: poseidon_cuda.compress(_zeros(6, 8)), {"plonky2_poseidon_compress"}),
    "sponge": (lambda: poseidon_cuda.sponge(_zeros(7, 13), 14), {"plonky2_poseidon_sponge"}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_launches_on_the_tensors_card(cards, case):
    call, entries = _CASES[case]
    call()
    assert {name for name, _, _ in cards.launches} == entries
    for name, current, stream_card in cards.launches:
        assert (current, stream_card) == (TENSORS, TENSORS), (
            f"{name} launched with card {current} current on card {stream_card}'s stream, "
            f"tensors on card {TENSORS}")
    assert cards.cards.current == CURRENT


@pytest.mark.parametrize("wrapper", ["col_fft", "row_fft"])
def test_ntt_refuses_a_twiddle_table_on_another_card(cards, monkeypatch, wrapper):
    import torch

    monkeypatch.setattr(ntt_cuda.load(), "_table",
                        lambda n_log, inverse, device: torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="twiddle table on meta"):
        if wrapper == "col_fft":
            ntt_cuda.col_fft(_zeros(2, 1 << 8, 16), 8, 0, True)
        else:
            ntt_cuda.row_fft(_zeros(2, 1 << 10), 10, 0, False)
    assert cards.launches == []


def _entry_body(text: str, name: str) -> str:
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("entry, kernel", [("plonky2_col_fft_pass", "col_fft_kernel"),
                                           ("plonky2_row_fft_pass", "row_fft_kernel")])
def test_ntt_pass_raises_its_kernels_smem_limit_before_each_launch(entry, kernel):
    with open(_NTT_CU) as f:
        text = f.read()
    body = _entry_body(text, entry)
    raise_at = body.find(f"ntt_raise_smem({kernel})")
    assert 0 <= raise_at < body.index(f"{kernel}<<<")
    helper = text[text.index("static int ntt_raise_smem("):]
    helper = helper[:helper.index("\n}\n")]
    assert "cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize" in helper
    assert "if" not in helper  # no state decides whether it is raised


def test_ntt_cu_keeps_no_state_between_calls():
    """No variable at file scope: a flag or a cache there would stand for
    every card the process launches on."""
    with open(_NTT_CU) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    state = re.findall(r"^(?:static\s+)?(?:const\s+)?[A-Za-z_][\w:<>]*\s+\**\w+\s*(?:\[[^\]]*\])?"
                       r"\s*(?:=[^;{(]*)?;", text, flags=re.M)
    assert state == []
