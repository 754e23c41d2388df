"""The intra codec's container paths under the port's recorder
(``runtime/trace.py``), and its decode that leaves the validity flag on the
device.

On the CPU: ``IntraCodec.encode_to_container`` records ``ivc.intra.encode``
over ``symbolize``, ``pack`` and ``serialize``, and
``decode_from_container`` records ``ivc.intra.decode`` over the video
decodes' four phases; every host read of a device value on the two paths is
an ``ivc.fetch`` (five an encode, one a decode, none with
``return_device=True``); ``return_device=True`` gives the default path's
reconstruction and a device ``ok``, which reads false on a corrupt stream
where the default path raises; the bytes are the same whether the recorder
is on or off. On a card (``-m cuda``), the ``syncs`` counter equals what
``utils/timing.py::host_syncs`` finds on both paths.

This file imports neither JAX nor ``ivclab_tpu``, so it also runs on the GPU
machine (tests/conftest.py imports JAX, hence ``--noconftest``):

    python3 -m pytest tests/test_torch_intra_trace.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ivclab_tpu_torch.models.intracodec import IntraCodec
from ivclab_tpu_torch.runtime import container as ct
from ivclab_tpu_torch.runtime import trace
from ivclab_tpu_torch.utils import fixtures

ENCODE = ("ivc.intra.encode", [
    ("ivc.intra.symbolize", []),
    ("ivc.intra.pack", [("ivc.fetch", [])] * 2),
    ("ivc.intra.serialize", [("ivc.fetch", [])] * 3)])
PHASES = ("ivc.decode.parse", "ivc.decode.tables", "ivc.decode.upload")


def _decode_tree(fetches: int):
    return ("ivc.intra.decode", [(n, []) for n in PHASES]
            + [("ivc.decode.enqueue", [("ivc.fetch", [])] * fetches)])


@pytest.fixture(autouse=True)
def off_and_empty():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


def _image(shape=(64, 128), seed: int = 3) -> np.ndarray:
    """An RGB photo crop with noise of its own, so the symbols are many."""
    img = np.tile(fixtures.image("lena_small"), (2, 2, 1))[:shape[0], :shape[1]]
    noise = np.random.default_rng(seed).normal(0, 6, img.shape)
    return np.clip(np.round(img + noise), 0, 255).astype(np.uint8)


def _codec(img, q: float = 0.15, device="cpu") -> IntraCodec:
    codec = IntraCodec(q, device=device)
    codec.train_huffman_from_image(img)
    return codec


def _tree(request: dict) -> list:
    """A request's spans as nested ``(name, [children])``, in order."""
    kids: dict = {}
    for s in request["spans"]:
        kids.setdefault(s["parent"], []).append(s)

    def build(pid):
        return [(s["name"], build(s["id"])) for s in kids.get(pid, [])]

    return build(None)


def _corrupt(blob: bytes) -> bytes:
    """Block 0 of the sidecar now ends before its EOB."""
    payload = ct.IntraPayload.from_bytes(blob)
    data = bytearray(blob)
    counts_at = len(data) - 4 * int(payload.group_word_counts.sum()) - payload.block_counts.size
    data[counts_at] = 1
    return bytes(data)


@pytest.mark.parametrize("call,fetches", [("encode", 5), ("decode", 1),
                                          ("decode_on_device", 0)])
def test_each_intra_call_emits_its_span_tree_with_a_fetch_at_each_read(call, fetches):
    """Parents link as the trees say; the ``ivc.fetch`` spans are the host
    reads of one image: 5 an encode (the symbol count and the group bits
    in ``pack``, the offsets, words and counts in ``serialize``), 1 a
    decode (its ``ok``), 0 a decode with ``return_device=True``."""
    img = _image()
    codec = _codec(img)
    blob = codec.encode_to_container(img)
    calls = {"encode": lambda: codec.encode_to_container(img),
             "decode": lambda: IntraCodec.decode_from_container(blob, device="cpu"),
             "decode_on_device": lambda: IntraCodec.decode_from_container(
                 blob, device="cpu", return_device=True)}
    trace.enable()
    calls[call]()
    (request,) = trace.requests()
    assert _tree(request) == [ENCODE if call == "encode" else _decode_tree(fetches)]
    spans = request["spans"]
    assert sum(s["name"] == "ivc.fetch" for s in spans) == fetches
    root = next(s for s in spans if s["parent"] is None)
    assert all(s["parent"] == root["id"] for s in spans
               if s["name"] in ("ivc.intra.symbolize", "ivc.intra.pack", "ivc.intra.serialize",
                                *PHASES, "ivc.decode.enqueue"))


@pytest.mark.parametrize("q,shape", [(0.15, (64, 128)), (1.0, (64, 128)), (0.5, (45, 61))])
def test_return_device_gives_the_default_reconstruction_and_ok(q, shape):
    img = _image(shape)
    blob = _codec(img, q).encode_to_container(img)
    default = IntraCodec.decode_from_container(blob, device="cpu")
    recon, ok = IntraCodec.decode_from_container(blob, device="cpu", return_device=True)
    assert isinstance(ok, torch.Tensor) and ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok)
    assert recon.shape == (*shape, 3) and torch.equal(recon, default)


def test_a_corrupt_container_reads_ok_false_on_the_device_and_raises_by_default():
    img = _image()
    bad = _corrupt(_codec(img).encode_to_container(img))
    recon, ok = IntraCodec.decode_from_container(bad, device="cpu", return_device=True)
    assert not bool(ok) and recon.shape == (64, 128, 3)
    with pytest.raises(ValueError, match="container decode failed"):
        IntraCodec.decode_from_container(bad, device="cpu")


@pytest.mark.parametrize("q", [0.15, 1.0])
def test_the_bytes_and_reconstruction_are_the_same_with_the_recorder_on(q):
    img = _image()
    codec = _codec(img, q)
    off = codec.encode_to_container(img)
    off_recon = IntraCodec.decode_from_container(off, device="cpu")
    assert trace.requests() == []
    trace.enable()
    on = codec.encode_to_container(img)
    on_recon, ok = IntraCodec.decode_from_container(on, device="cpu", return_device=True)
    assert [r["name"] for r in trace.requests()] == ["ivc.intra.encode", "ivc.intra.decode"]
    assert on == off and bool(ok) and torch.equal(on_recon, off_recon)


@pytest.mark.cuda
def test_the_intra_syncs_counter_equals_host_syncs_on_the_card(cuda_device):
    from ivclab_tpu_torch.utils.timing import host_syncs

    img = torch.from_numpy(_image((256, 384))).to(cuda_device)
    codec = _codec(img, device=cuda_device)
    blob = codec.encode_to_container(img)  # builds the kernels
    IntraCodec.decode_from_container(blob, device=cuda_device)
    calls = {
        "encode_to_container": (lambda: codec.encode_to_container(img), 5),
        "decode_from_container": (
            lambda: IntraCodec.decode_from_container(blob, device=cuda_device), 1),
        "decode_from_container(return_device=True)": (
            lambda: IntraCodec.decode_from_container(blob, device=cuda_device,
                                                     return_device=True), 0),
    }
    for name, (fn, want) in calls.items():
        trace.enable()
        found = sum(n for _, n in host_syncs(fn))
        counted = trace.summary()["counts"].get("syncs", 0)
        trace.disable()
        assert counted == found == want, (name, counted, found)
    trace.enable()
    codec.encode_to_container(img)
    torch.cuda.synchronize()
    (ms,) = [s["device_ms"] for r in trace.requests() for s in r["spans"]
             if s["name"] == "ivc.intra.encode"]
    assert ms is not None and ms > 0
