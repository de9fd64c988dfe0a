"""The plain reference against the program (`repro_torch`) at a tiny
size on the CPU, and the plain image reader against the program's
images."""
import os

import numpy as np
import pytest
import torch

from bench import state as S
from bench import training as T
from bench.reference import image as ref_image
from bench.reference import model as ref_model
from bench.tests import tiny


@pytest.mark.parametrize("name,batch", [("qwen2-0.5b", 2),
                                        ("qwen2-0.5b", 1)])
def test_reference_follows_the_program(name, batch):
    """Two steps of the program's train step and of the reference, from
    the same state and batches, in float32: losses and every param leaf
    agree to rounding."""
    from repro_torch.training.step import make_train_step

    cfg_file = tiny.config(name)
    traffic = {"name": "t", "batch": batch, "seq": 64}
    cfg, rc = T.program_config(cfg_file, traffic)
    step = make_train_step(cfg, rc)
    state = S.make_train_state(cfg_file, 5, "cpu")
    data = S.TokenBatches(cfg_file["vocab_size"], batch, 64, 5)
    batches = [{k: torch.from_numpy(v) for k, v in data.get_batch(i).items()}
               for i in range(2)]
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    p0 = {k[len("params/"):]: v
          for k, v in S.make_params(cfg_file, 5, "cpu").items()}
    ref = ref_model.train(cfg_file, p0, batches)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    got = S.flat(state["params"])
    for k, v in ref["params"].items():
        torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["qwen2-0.5b"])
def test_layout_is_the_programs(name):
    """The benchmark's state layout at the published sizes is the
    program's (shapes of its abstract train state on the meta device)."""
    from repro_torch.training.step import abstract_train_state

    cfg_file = tiny.harness.load_json(os.path.join(
        tiny.ROOT, "bench", "configs", name + ".json"))
    cfg, rc = T.program_config(cfg_file, {"name": "t", "batch": 1,
                                          "seq": 128})
    theirs = {k: tuple(v.shape) for k, v in
              S.flat(abstract_train_state(cfg, rc)["params"]).items()}
    mine = {k[len("params/"):]: s for k, (s, _) in
            S.param_layout(cfg_file).items()}
    assert mine == theirs


def _image(tmp_path, cfg_file):
    from repro_torch.core.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), quantize_keys=("opt/m", "opt/v"),
                            device="cpu")
    state = S.make_train_state(cfg_file, 9, "cpu")
    for tree in (state["opt"]["m"], state["opt"]["v"]):
        for leaf in S.flat(tree).values():
            leaf.normal_()
    mgr.save(3, state, extra={"data": {"seed": 9, "step": 3}})
    return mgr.step_dir(3), S.flat(state)


def test_plain_reader_reads_the_programs_image(tmp_path):
    step_dir, held = _image(tmp_path, tiny.config("qwen2-0.5b"))
    arrays, coded, extra, report = ref_image.read_image(step_dir, "cpu")
    assert report["bad_digests"] == [] and extra["data"]["step"] == 3
    assert set(arrays) == set(held)
    for k, v in arrays.items():
        if k in coded:
            assert ref_image.quantization_error(held[k], coded[k]) <= 1.00002
        else:
            assert torch.equal(v, held[k])


def test_plain_reader_finds_an_altered_chunk(tmp_path):
    step_dir, _ = _image(tmp_path, tiny.config("qwen2-0.5b"))
    name = sorted(f for f in os.listdir(step_dir) if f.startswith("params"))[0]
    with open(os.path.join(step_dir, name), "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 1]))
    _, _, _, report = ref_image.read_image(step_dir, "cpu")
    assert report["bad_digests"] == [name]


@pytest.mark.parametrize("n", [0, 1, 4 * 2048 - 1, 4 * 2048 * 3 + 5])
def test_frozen_digest_and_decode_match_the_programs(n):
    from repro_torch.kernels.checksum.ref import checksum_np
    from repro_torch.kernels.quantize.ref import dequantize_np, quantize_np

    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert ref_image.digest(torch.from_numpy(raw)) == checksum_np(raw)
    x = np.random.default_rng(n).standard_normal(max(n, 1)).astype(np.float32)
    q, s, pad = quantize_np(x)
    got = ref_image.dequantize(torch.from_numpy(q), torch.from_numpy(s), pad,
                               x.shape)
    assert np.array_equal(got.numpy(), dequantize_np(q, s, pad, x.shape,
                                                     np.float32))


@pytest.mark.cuda
def test_frozen_digest_on_the_card(cuda_card):
    from repro_torch.kernels.checksum.ops import checksum

    raw = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8,
                        device=cuda_card)
    assert ref_image.digest(raw) == checksum(raw)
