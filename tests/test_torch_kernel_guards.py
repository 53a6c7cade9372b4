"""The hand-written kernels' memory safety, checked in pure Python on the
CPU (no kernel runs here):

- the ring of recent launches in ops/cuda_build.py, which ``raise_on``
  names when a launch reports an error (an illegal address is sticky and
  reported at a later launch), fed by the wrappers, driven here with a
  stand-in library;
- the wrappers' ``out`` tensors;
- the NTT launch plans (ops/ntt_cuda.col_plan, row_plan) against the
  buffers they run over: the offsets of csrc/ntt.cu's col_fft_kernel,
  row_fft_kernel (:239-265), pass_group (:141-172) and ntt_stage_kernel
  (:276-294), transcribed, over the forms of tests/test_torch_ntt.py's
  plan sweeps;
- chip_smoke.py's guarded buffers, which phase kernel_guards puts around
  every kernel's inputs and output on the card.
"""

import ast
import os
import types

import numpy as np
import pytest

from _torch_port import lazy_module

cuda_build = lazy_module("plonky2_tpu_torch.ops.cuda_build")
field_cuda = lazy_module("plonky2_tpu_torch.ops.field_cuda")
ntt_cuda = lazy_module("plonky2_tpu_torch.ops.ntt_cuda")
poseidon_cuda = lazy_module("plonky2_tpu_torch.ops.poseidon_cuda")
cs = lazy_module("chip_smoke")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The launch ring and raise_on
# ---------------------------------------------------------------------------


def test_ring_keeps_launches_in_order():
    cuda_build.reset_launches()
    for i in range(3):
        cuda_build.note_launch(f"k{i}", (i, i + 1))
    assert list(cuda_build.RECENT_LAUNCHES) == [("k0", (0, 1)), ("k1", (1, 2)), ("k2", (2, 3))]
    cuda_build.reset_launches()


def test_ring_keeps_the_last_sixteen():
    cuda_build.reset_launches()
    assert cuda_build.RING_SIZE == 16
    for i in range(40):
        cuda_build.note_launch("k", i)
    assert [f for _, f in cuda_build.RECENT_LAUNCHES] == list(range(24, 40))
    cuda_build.reset_launches()


@pytest.mark.parametrize("module", ["cuda_build", "field_cuda", "ntt_cuda", "poseidon_cuda"])
def test_reset_launches_clears_the_ring(module):
    cuda_build.note_launch("k", 1)
    globals()[module].reset_launches()
    assert len(cuda_build.RECENT_LAUNCHES) == 0


def test_raise_on_names_the_error_and_the_recent_launches():
    cuda_build.reset_launches()
    cuda_build.note_launch("col_fft_kernel", (83, 8, 8))
    cuda_build.note_launch("gl_mul_kernel", ((1328, 4096), (4096, 1), (0, 1)))
    cuda_build.raise_on(0, "gl mul")  # no error: no exception
    with pytest.raises(RuntimeError) as e:
        cuda_build.raise_on(700, "gl mul")
    text = str(e.value)
    assert text.startswith("gl mul: kernel launch failed, cudaError 700 (cudaErrorIllegalAddress)")
    assert "last 2 launches, oldest first: col_fft_kernel (83, 8, 8); gl_mul_kernel" in text
    assert text.index("col_fft_kernel") < text.index("gl_mul_kernel")
    cuda_build.reset_launches()
    with pytest.raises(RuntimeError, match=r"cudaError 12345; the port's last 0 launches.*none"):
        cuda_build.raise_on(12345, "x")


# ---------------------------------------------------------------------------
# The wrappers on a stand-in library: what they note, and their out tensors
# ---------------------------------------------------------------------------


class _StandIn:
    """A library whose entry points return 0, or ``err`` at the
    ``fail_at``-th call (1-based); records the names called."""

    def __init__(self, fail_at=None, err=700):
        self.calls = []
        self.fail_at, self.err = fail_at, err

    def load(self):
        return self

    def __getattr__(self, name):
        if not name.startswith("plonky2_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            return self.err if len(self.calls) == self.fail_at else 0

        return entry


@pytest.fixture
def stand_in(monkeypatch):
    """The three bindings on CPU tensors, their libraries stand-ins."""
    import contextlib

    import torch

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ntt_cuda.load(), "_check", lambda x, what: None)
    monkeypatch.setattr(ntt_cuda.load(), "_stream", lambda x: 0)
    monkeypatch.setattr(ntt_cuda.load(), "_table",
                        lambda n_log, inverse, device: torch.zeros(1, dtype=torch.int64))
    monkeypatch.setattr(field_cuda.load(), "_check", lambda x, what: None)
    monkeypatch.setattr(poseidon_cuda.load(), "_check", lambda x, width, what: None)

    def use(fail_at=None):
        lib = _StandIn(fail_at)
        for m in (ntt_cuda, field_cuda, poseidon_cuda):
            monkeypatch.setattr(m.load(), "LIB", lib)
        return lib

    cuda_build.reset_launches()
    yield use
    for m in (ntt_cuda, field_cuda, poseidon_cuda):
        m.reset_launches()


def test_col_fft_notes_each_pass_and_tail_stage(stand_in):
    import torch

    lib = stand_in()
    x = torch.zeros(3, 1 << 13, 4, dtype=torch.int64)
    y = ntt_cuda.col_fft(x, 13, 0, False)
    passes, tail = ntt_cuda.col_plan(13, 2, 0)
    assert tail == 12 and len(passes) == 2
    want = [("col_fft_kernel", (3, 13, 2, p)) for p in passes]
    want.append(("ntt_stage_kernel", (3, 13, 2, 12)))
    assert list(cuda_build.RECENT_LAUNCHES) == want
    assert lib.calls == ["plonky2_col_fft_pass"] * 2 + ["plonky2_ntt_stage"]
    assert ntt_cuda.LAUNCHES["col_fft"] == 3 and y.shape == x.shape


def test_row_fft_notes_each_pass(stand_in):
    import torch

    stand_in()
    x = torch.zeros(2, 1 << 15, dtype=torch.int64)
    ntt_cuda.row_fft(x, 15, 0, False)
    passes, _ = ntt_cuda.row_plan(2, 15, 0)
    assert list(cuda_build.RECENT_LAUNCHES) == [("row_fft_kernel", (2, 15, p)) for p in passes]


def test_error_at_a_later_launch_names_the_earlier_ones(stand_in):
    """An error reported at the product's launch (a sticky fault of an
    earlier kernel shows there) lists the column FFT's launches before it:
    the [83, 2^16] inverse four-step's first pass, then the twiddle
    product."""
    import torch

    stand_in(fail_at=2)
    ntt_cuda.col_fft(torch.zeros(83, 1 << 8, 1 << 8, dtype=torch.int64), 8, 0, True)
    a = torch.zeros(1328, 4096, dtype=torch.int64)
    with pytest.raises(RuntimeError) as e:
        field_cuda.mul(a, torch.zeros(4096, dtype=torch.int64))
    text = str(e.value)
    assert "gl mul: kernel launch failed, cudaError 700 (cudaErrorIllegalAddress)" in text
    assert "last 2 launches" in text
    assert (text.index("col_fft_kernel (83, 8, 8, ColPass(first=0, last=8, lanes_log=5")
            < text.index("gl_mul_kernel ((1328, 4096), (4096, 1), (0, 1))"))
    assert field_cuda.LAUNCHES["mul"] == 0  # a refused launch is not counted


def test_poseidon_wrappers_note_their_forms(stand_in):
    import torch

    stand_in()
    poseidon_cuda.permute(torch.zeros(5, 12, dtype=torch.int64))
    poseidon_cuda.compress(torch.zeros(6, 8, dtype=torch.int64))
    poseidon_cuda.sponge(torch.zeros(7, 13, dtype=torch.int64), 14)
    assert list(cuda_build.RECENT_LAUNCHES) == [
        ("poseidon_permute_kernel", 5), ("poseidon_compress_kernel", 6),
        ("poseidon_sponge_kernel", (7, 13, 14))]


def test_wrappers_write_into_out(stand_in):
    import torch

    stand_in()
    x = torch.zeros(2, 1 << 10, dtype=torch.int64)
    out = torch.empty_like(x)
    assert ntt_cuda.row_fft(x, 10, 0, False, out=out) is out
    col = torch.zeros(2, 1 << 5, 4, dtype=torch.int64)
    out = torch.empty_like(col)
    assert ntt_cuda.col_fft(col, 5, 0, False, out=out) is out
    out = torch.empty(3, 4, dtype=torch.int64)
    assert field_cuda.mul(torch.zeros(3, 4, dtype=torch.int64), 7, out=out) is out
    out = torch.empty(5, 12, dtype=torch.int64)
    assert poseidon_cuda.permute(torch.zeros(5, 12, dtype=torch.int64), out=out) is out
    out = torch.empty(6, 4, dtype=torch.int64)
    assert poseidon_cuda.compress(torch.zeros(6, 8, dtype=torch.int64), out=out) is out
    out = torch.empty(7, 4, dtype=torch.int64)
    assert poseidon_cuda.sponge(torch.zeros(7, 9, dtype=torch.int64), 0, out=out) is out


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_out_of_the_wrong_form_is_refused(bad):
    import torch

    like = torch.zeros(4, 8, dtype=torch.int64)
    out = {
        "shape": torch.empty(4, 9, dtype=torch.int64),
        "dtype": torch.empty(4, 8, dtype=torch.int32),
        "strided": torch.empty(8, 4, dtype=torch.int64).T,
    }[bad]
    with pytest.raises(ValueError, match="out must be"):
        cuda_build.check_out(out, (4, 8), like, "k")
    good = torch.empty(4, 8, dtype=torch.int64)
    assert cuda_build.check_out(good, (4, 8), like, "k") is good


# ---------------------------------------------------------------------------
# The NTT plans against their buffers
# ---------------------------------------------------------------------------


def _assigned_list(path, name):
    """The list assigned to ``name`` at the top of a script, evaluated
    without importing the script (both import torch)."""
    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            return eval(compile(ast.Expression(node.value), path, "eval"), {})
    raise LookupError(f"{path} assigns no {name}")


# the forms of tests/test_torch_ntt.py's col_plan and row_plan sweeps
_COL_FORMS = sorted(
    {(k, lanes, first) for _, k, lanes, first, _ in _assigned_list("chip_smoke.py", "COL_FFT_FIXED")}
    | {(k, lanes, first) for _, k, lanes, first, _ in
       _assigned_list("tools/torch_ntt_variants.py", "MAIN_PATH_COL_FORMS")}
    | {(k, 1 << l, first) for k in range(1, 14) for l in range(13) for first in range(4)}
)
_ROW_FORMS = sorted(
    {(rows, n, first) for rows, n, first, _ in _assigned_list("chip_smoke.py", "ROW_FFT_FIXED")}
    | {(rows, n, first) for rows, n, first, _ in
       _assigned_list("tools/torch_ntt_variants.py", "MAIN_PATH_ROW_FORMS")}
    | {(rows, n, first) for n in range(1, 21) for rows in (1, 2, 3, 16, 143)
       for first in range(4)}
)
# buffers of at most this many words are enumerated word by word
_ENUMERATE_WORDS = 1 << 16


def _swizzle(w):
    """ntt.cu col_swizzle."""
    return w ^ ((w >> 4) & 15)


def _col_tile_base(blk, l_log, p):
    """ntt.cu col_fft_kernel: block blk's first word and jt."""
    a, b, lt = p.first, p.last, p.lanes_log
    tiles_l_log = l_log - lt
    lane_tile = blk & ((1 << tiles_l_log) - 1)
    jt = (blk >> tiles_l_log) & ((1 << a) - 1)
    hb = blk >> (tiles_l_log + a)
    return (hb << (b + l_log)) + (jt << l_log) + (lane_tile << lt), jt


def _row_tile_base(blk, hbs, p):
    """ntt.cu row_fft_kernel: block blk's first word, jt and nb."""
    a, b, lt, rb = p.first, p.last, p.lanes_log, p.rows_log
    jt = (blk & ((1 << (a - lt)) - 1)) << lt
    hb = (blk >> (a - lt)) << rb
    nb = np.minimum(hbs - hb, 1 << rb)
    return (hb << b) + jt, jt, nb


def _groups_of_a_tile(p, pos_log, h_log, row, nb):
    """ntt.cu pass_group for each stage group of a tile of ``nb`` rows or
    chunks (one for a column pass): the device words it reads or writes
    (relative to the tile's first word), the shared-memory words it
    touches, and the highest twiddle index it reads less the tile's jt."""
    a, n, lt = p.first, p.last - p.first, p.lanes_log
    out = []
    s = 0
    for G in p.groups:
        idx = np.arange((nb if row else 1) << (n - G + lt), dtype=np.int64)
        lane = idx & ((1 << lt) - 1)
        r = idx >> lt
        q = r & ((1 << (n - G)) - 1) if row else r
        jl = q & ((1 << s) - 1)
        i0 = ((q >> s) << (s + G)) | jl
        w0 = (i0 << lt) | lane
        g0 = (i0 << pos_log) + lane
        if row:
            h = r >> (n - G)
            w0 = w0 | (h << (n + lt))
            g0 = g0 + (h << h_log)
        m = np.arange(1 << G, dtype=np.int64)
        dev = (g0[:, None] + m[None, :] * (1 << (s + pos_log))).ravel()
        smem = _swizzle((w0[:, None] + m[None, :] * (1 << (s + lt))).ravel())
        S = a + s
        j = (lane if row else 0) + (jl << a)
        tw = (1 << (S + G - 1)) - 1 + int(np.max(j)) + ((1 << (G - 1)) - 1 << S)
        out.append((dev, smem, tw))
        s += G
    return out


def _check_tiles(bases, jts, tile_rel, groups, tile_words, table_words, total):
    """The tiles (first words ``bases``, relative words ``tile_rel``) lie
    in the buffer; each stage group covers exactly a tile's words and its
    shared-memory words once; the twiddles stay in the table."""
    for dev, smem, tw in groups:
        assert np.array_equal(np.sort(dev), np.sort(tile_rel))
        assert len(np.unique(smem)) == len(smem) and smem.min() >= 0 and smem.max() < tile_words
        assert int(np.max(jts)) + tw < table_words
    assert int(bases.min()) >= 0 and int(bases.max()) + int(tile_rel.max()) < total


@pytest.mark.parametrize("k_log, lanes, first", _COL_FORMS, ids=lambda v: str(v))
def test_col_plan_stays_inside_its_buffer(k_log, lanes, first):
    for batch in (1, 3):
        _check_col_plan(batch, k_log, lanes, first)


def _check_col_plan(batch, k_log, lanes, first):
    l_log = lanes.bit_length() - 1
    total = batch << (k_log + l_log)
    passes, tail = ntt_cuda.col_plan(k_log, l_log, first)
    for p in passes:
        a, b, lt = p.first, p.last, p.lanes_log
        n = b - a
        tile = 1 << (n + lt)
        # plonky2_col_fft_pass's grid: its tiles cover the buffer exactly
        blocks = batch << (k_log - n + l_log - lt)
        assert blocks * tile == total and blocks < 1 << 31
        # the last block's last word is the buffer's last
        g, _ = _col_tile_base(blocks - 1, l_log, p)
        assert g + (((1 << n) - 1) << (a + l_log)) + (1 << lt) - 1 == total - 1
        tile_rel = ((np.arange(1 << n)[:, None] << (a + l_log))
                    + np.arange(1 << lt)[None, :]).ravel()
        if total <= _ENUMERATE_WORDS:
            bases, jts = _col_tile_base(np.arange(blocks, dtype=np.int64), l_log, p)
            words = (bases[:, None] + tile_rel[None, :]).ravel()
            assert np.array_equal(np.sort(words), np.arange(total))
        else:
            bases, jts = _col_tile_base(np.array([0, blocks - 1], dtype=np.int64), l_log, p)
            jts = np.array([(1 << a) - 1])
        _check_tiles(bases, jts, tile_rel, _groups_of_a_tile(p, a + l_log, 0, False, 1), tile,
                     (1 << k_log) - 1, total)
    _check_tail(batch, k_log, l_log, tail)


@pytest.mark.parametrize("rows, n_log, first", _ROW_FORMS, ids=lambda v: str(v))
def test_row_plan_stays_inside_its_buffer(rows, n_log, first):
    total = rows << n_log
    passes, tail = ntt_cuda.row_plan(rows, n_log, first)
    for p in passes:
        a, b, lt, rb = p.first, p.last, p.lanes_log, p.rows_log
        n = b - a
        hbs = p.batch(rows, n_log) << (p.k_log - b)
        # plonky2_row_fft_pass's grid, and the plan's count of it
        blocks = ((hbs + (1 << rb) - 1) >> rb) << (a - lt)
        assert blocks == p.blocks(rows, n_log) and blocks < 1 << 31
        bases, jts, nbs = _row_tile_base(np.arange(blocks, dtype=np.int64), hbs, p)
        # the tiles hold the buffer's count of words, the last one ends it
        assert int(nbs.sum()) << (n + lt) == total and nbs.min() >= 1
        last = bases + ((nbs - 1) << b) + (((1 << n) - 1) << a) + (1 << lt) - 1
        assert int(last.max()) == total - 1 and int(bases.min()) == 0
        covered = []
        for nb in np.unique(nbs):  # whole tiles, and the last tile of fewer rows
            nb = int(nb)
            tile_rel = ((np.arange(nb)[:, None, None] << b)
                        + (np.arange(1 << n)[None, :, None] << a)
                        + np.arange(1 << lt)[None, None, :]).ravel()
            these = nbs == nb
            _check_tiles(bases[these], jts[these], tile_rel,
                         _groups_of_a_tile(p, a, b, True, nb), 1 << (rb + n + lt),
                         (1 << p.k_log) - 1, total)
            if total <= _ENUMERATE_WORDS:
                covered.append((bases[these][:, None] + tile_rel[None, :]).ravel())
        if total <= _ENUMERATE_WORDS:
            assert np.array_equal(np.sort(np.concatenate(covered)), np.arange(total))
    _check_tail(rows, n_log, 0, tail)


def _check_tail(batch, k_log, l_log, tail):
    """ntt_stage_kernel at each tail stage: its butterflies' two words in
    the buffer, each word once a stage."""
    total = batch << (k_log + l_log)
    for s in range(tail, k_log):
        butterflies = batch << (k_log - 1 + l_log)
        idx = np.arange(butterflies, dtype=np.int64) if total <= _ENUMERATE_WORDS else \
            np.array([0, butterflies - 1], dtype=np.int64)
        lane = idx & ((1 << l_log) - 1)
        rest = idx >> l_log
        q = rest & ((1 << (k_log - 1)) - 1)
        bt = rest >> (k_log - 1)
        j = q & ((1 << s) - 1)
        p0 = ((q >> s) << (s + 1)) | j
        i0 = (((bt << k_log) + p0) << l_log) + lane
        i1 = i0 + ((1 << s) << l_log)
        assert i0.min() >= 0 and i1.max() < total and (1 << s) - 1 + j.max() < (1 << k_log) - 1
        if total <= _ENUMERATE_WORDS:
            assert np.array_equal(np.sort(np.concatenate([i0, i1])), np.arange(total))


# ---------------------------------------------------------------------------
# chip_smoke.py's guarded buffers
# ---------------------------------------------------------------------------


def _guard_report(call, inputs, want):
    import torch

    gen = torch.Generator()
    gen.manual_seed(5)
    report = {"forms": {}, "failures": []}
    cs.run_guarded(gen, report, "k", "form", call, inputs, want)
    return report


def test_guarded_buffers_pass_a_kernel_that_keeps_inside():
    import torch

    x = torch.arange(24, dtype=torch.int64).view(4, 6)
    view = x[:, 1::2]  # a strided input: its gaps are copied along and must stay
    report = _guard_report(lambda v, out: out.copy_(v * 3), [view], view * 3)
    assert report == {"forms": {"k": 1}, "failures": []}


@pytest.mark.parametrize("fault, problem", [
    ("past_out", "the output's margins changed"),
    ("before_out", "the output's margins changed"),
    ("input", "an input or its margins changed"),
    ("input_gap", "an input or its margins changed"),
    ("new_tensor", "the result is not in out"),
    ("wrong", "the output differs from the plain version"),
])
def test_guarded_buffers_catch_a_kernel_that_strays(fault, problem):
    import torch

    def full(t):
        return torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())

    def call(v, out):
        out.copy_(v * 3)
        if fault == "past_out":
            full(out)[out.storage_offset() + out.numel()] += 1
        elif fault == "before_out":
            full(out)[out.storage_offset() - 1] += 1
        elif fault == "input":
            v[0, 0] += 1
        elif fault == "input_gap":
            full(v)[v.storage_offset() + 1] += 1
        elif fault == "new_tensor":
            return v * 3
        elif fault == "wrong":
            out[-1, -1] += 1
        return out

    x = torch.arange(24, dtype=torch.int64).view(4, 6)
    view = x[:, ::2]
    report = _guard_report(call, [view], view * 3)
    assert report["forms"] == {"k": 1}
    assert [problem] == [p for f in report["failures"] for p in f["problems"] if p == problem]


def test_guard_words_cover_a_tile_on_each_side():
    """At least one 64 KiB tile of random words before and after."""
    assert cs.GUARD_WORDS * 8 >= 64 * 1024
