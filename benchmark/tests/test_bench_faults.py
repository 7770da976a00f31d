"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced (K1's output for decode, K2's for
encode, each in every frame or in one block a frame), and half of a call's frames left out. The look for a card is
skipped: the small cells run the program's CPU twins. (A step that returns
its state unchanged and the exchange between chips do not exist in these
cells: no state is carried from call to call, and each runs on one card.)"""

from __future__ import annotations

import pytest

from conftest import CELLS, run_tiny


def test_decode_answer_altered(tiny_root, monkeypatch):
    from jpeg_tpu_torch.parallel import pipeline

    real = pipeline.decode_batch_fast

    def altered(*args, **kwargs):
        return real(*args, **kwargs) ^ 0x10  # every frame of the launch

    monkeypatch.setattr(pipeline, "decode_batch_fast", altered)
    res = run_tiny(tiny_root, CELLS[0])
    assert not res["correct"] and res["failed"] == 0
    assert res["check"]["differ_share"]["value"] > res["check"]["differ_share"]["limit"]


def test_decode_one_block_altered(tiny_root, monkeypatch):
    from jpeg_tpu_torch.parallel import pipeline

    real = pipeline.decode_batch_fast

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:, 0, :8, :8] += 8  # one 8x8 block of one plane, every frame
        return out

    monkeypatch.setattr(pipeline, "decode_batch_fast", altered)
    res = run_tiny(tiny_root, CELLS[0])
    assert not res["correct"] and res["failed"] == 0
    v = res["check"]["differ_over1"]
    assert v["value"] > v["limit"]


def test_decode_half_left_out(tiny_root, monkeypatch):
    from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

    real = BatchedCorpusDecoder.decode_all
    monkeypatch.setattr(BatchedCorpusDecoder, "decode_all",
                        lambda self, items: real(self, items)[: len(items) // 2])
    res = run_tiny(tiny_root, CELLS[0])
    assert not res["correct"] and res["failed"] >= res["attempted"] // 2


@pytest.mark.parametrize("where", ["coefficient", "bytes"])
def test_encode_answer_altered(tiny_root, monkeypatch, where):
    import jpeg_tpu_torch.parallel.batch as batch
    from benchmark.entries import encode_rgb_device as entry

    if where == "coefficient":
        real = batch.encode_batch_device

        def altered(*args, **kwargs):
            planes = real(*args, **kwargs)
            planes[0][0, 0, 0] += 3  # the first luma DC, every frame
            return planes

        monkeypatch.setattr(batch, "encode_batch_device", altered)
    else:
        real_entry = entry.Entry.call
        monkeypatch.setattr(entry.Entry, "call", lambda self, item: (
            lambda d: d[:-40] + bytes(38) + d[-2:])(real_entry(self, item)))
    res = run_tiny(tiny_root, CELLS[1])
    assert not res["correct"]
    for name in ("coef_differ_share", "coef_over1"):
        v = res["check"][name]
        assert v["value"] > v["limit"]
