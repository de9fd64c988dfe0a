"""The comparison that decides `correct`, shown to fail: whole runs of
the harness on the CPU at a tiny size (the look for a card skipped),
sound and with the timed path broken underneath, and the control, the
reference in fp8 in the program's place."""
import pytest
import torch

from bench import harness
from bench import training as T
from bench.tests import tiny

# the cells, and the ckpt cell's mix with no image (the train driver's
# other path), as "<cell>[+no-image]"
CELLS = ("qwen2-0.5b.train-ckpt+no-image", "qwen2-0.5b.train-ckpt",
         "qwen2-0.5b.recover")


def _pieces(cell):
    name, _, variant = cell.partition("+")
    pieces = tiny.pieces(name)
    if variant == "no-image":
        pieces["traffic"].update(image=False, hold_at=0.5)
    return name, pieces


def _run(cell, seed=2 ** 31 + 17, seconds=1.5):
    name, pieces = _pieces(cell)
    return harness.execute(harness.manifest(), name, seed, seconds, False,
                           device="cpu", pieces=pieces, log=lambda *a: None)


def _broken_step(monkeypatch, fault, after=0):
    """Every train step the program makes is broken from its `after`-th
    call on (counted per step function)."""
    import repro_torch.training.step as step_mod

    make = step_mod.make_train_step

    def make_broken(cfg, rc, rules=None):
        inner = make(cfg, rc, rules)
        calls = []

        def step(state, batch):
            calls.append(1)
            if len(calls) <= after:
                return inner(state, batch)
            if fault == "half":
                half = batch["tokens"].shape[0] // 2
                return inner(state, {k: v[:half] for k, v in batch.items()})
            new, metrics = inner(state, batch)
            return state, metrics           # "unchanged"

        return step

    monkeypatch.setattr(step_mod, "make_train_step", make_broken)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    _broken_step(monkeypatch, fault)
    line = _run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_step_broken_after_set_up_is_not_correct(monkeypatch, cell, fault):
    """The first three steps sound, the window's broken: the window's
    steps after the held state fail, the set-up's pass."""
    _broken_step(monkeypatch, fault, after=T.SEED_STEPS)
    line = _run(cell)
    assert not line["correct"], line["checks"]
    assert line["checks"]["loss_gap"]["value"] <= line["checks"]["loss_gap"][
        "limit"]


@pytest.mark.parametrize("cell", ["qwen2-0.5b.train-ckpt",
                                  "qwen2-0.5b.recover"])
def test_an_altered_image_is_not_correct(monkeypatch, cell):
    """One byte of the first params chunk altered as it is written."""
    import repro_torch.core.checkpoint as ck

    host, seen = ck._host, []

    def altered(payload):
        out = host(payload)
        if not seen:
            seen.append(1)
            out = out.copy()
            out[0] ^= 1
        return out

    monkeypatch.setattr(ck, "_host", altered)
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["image_digests_bad"]["value"] >= 1


def test_an_altered_restore_is_not_correct(monkeypatch):
    """A restore that hands back one param leaf off by a rounding step."""
    import repro_torch.core.checkpoint as ck

    restore = ck.CheckpointManager.restore

    def altered(self, *a, **kw):
        state, extra = restore(self, *a, **kw)
        state["params"]["ln_f"] = torch.nextafter(
            state["params"]["ln_f"], torch.full_like(state["params"]["ln_f"],
                                                     2.0))
        return state, extra

    monkeypatch.setattr(ck.CheckpointManager, "restore", altered)
    line = _run("qwen2-0.5b.recover")
    assert not line["correct"]
    assert line["checks"]["restores_differ"]["value"] >= 1


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 2 ** 32 + 1])
def test_the_control_is_not_correct(tmp_path, seed):
    """The reference in fp8 (e4m3 operands, e5m2 gradients) put in the
    program's place, against the f32 reference, over the first three
    steps: at least one number past its limit."""
    name, pieces = _pieces(CELLS[0])
    cell = harness.find_cell(harness.manifest(), name)
    run = harness.Run(cell, pieces, seed, 0.0, False, torch.device("cpu"),
                      str(tmp_path))
    g = T.gaps(T.reference_first_steps(run, precision="fp8"),
               T.reference_first_steps(run))
    over = [k for k in ("loss_gap", "grad_gap", "change_gap")
            if not g[k] <= pieces["limits"][k]]
    assert over, g
