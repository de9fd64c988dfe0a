"""The port's MANARuntime end to end on the CPU (the cases of
tests/test_runtime_resume.py), and checkpoint images carried across
packages: a JAX image restores in the port and a port image restores
in the JAX `CheckpointManager`, with delta params and int8 moments on;
training images of reduced qwen2-0.5b, hymba-1.5b (its SSM leaves:
(L, 16) f32 constants, the conv weights), rwkv6-3b (its time-mix and
channel-mix leaves), whisper-large-v3 (its encoder stack, `enc_ln_f`
and the decoder's cross attention) and llama-3.2-vision-11b (its
(G, per-1, ...) self blocks and (G, ...) cross blocks), and decode-state
images of reduced Mixtral, hymba, rwkv6-3b, whisper and vision (bf16
caches, hymba's f32 SSM state and bf16 conv tail, rwkv's f32 `la` state
and bf16 token-shift states, whisper's and vision's bf16 cross K/V,
unchanged between the two images, vision's 6-D self K/V, the 0-d int32
pos).

Tolerance: none for images — restored params, steps, digests and chunk
bytes are compared exactly.  The one cross-package resume compares
losses at rtol 1e-4 (float32 compute; the model agrees to that, see
tests/test_torch_model.py); for whisper and vision the second resumed
step's loss, which follows an update from each package's own gradient,
at rtol 1e-3 (whisper's encoder gradients and vision's gradients agree
to 1e-3 of their norm, that file).
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.core.checkpoint import CheckpointManager as JCheckpointManager
from repro.core.runtime import MANARuntime as JMANARuntime
from repro.data.pipeline import SyntheticDataset as JSyntheticDataset
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.codec import ImageIntegrityError
from repro_torch.core.runtime import MANARuntime
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.kernels.checksum.ref import checksum_np

SHAPE = ShapeConfig("smoke", 64, 2, "train")


def _rc(cfg, **kw):
    return RunConfig(model=cfg, shape=SHAPE, loss_chunk=32, attn_chunk=16,
                     **kw)


def _jrc(cfg, **kw):
    return JRunConfig(model=cfg, shape=JShape("smoke", 64, 2, "train"),
                      loss_chunk=32, attn_chunk=16, **kw)


def _rt(cfg, rc, d, **kw):
    return MANARuntime(cfg, rc, ckpt_dir=str(d), device="cpu", **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_bitwise_resume(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = _rc(cfg)
    rt = _rt(cfg, rc, tmp_path, ckpt_every_steps=4)
    rt.initialize()
    hist = rt.run(10)
    assert rt.checkpoints_taken == 2
    assert rt.ckpt.steps() == [4, 8]

    rt2 = _rt(cfg, rc, tmp_path)
    assert rt2.restore(8) == 8
    hist2 = rt2.run(2)
    assert [h["loss"] for h in hist][8:10] == [h["loss"] for h in hist2]


def test_delta_chain_resume(tmp_path):
    """XOR-delta params: images 2, 4 (delta on 2), 6 (delta on 4); a
    restore of step 4 walks the chain and resumes bit for bit."""
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = _rc(cfg)
    rt = _rt(cfg, rc, tmp_path, ckpt_every_steps=2, delta_params=True)
    rt.initialize()
    hist = rt.run(6)
    with open(os.path.join(rt.ckpt.step_dir(6), "manifest.json")) as f:
        man = json.load(f)
    assert man["arrays"]["params/embed/embedding"]["base_step"] == 4
    rt2 = _rt(cfg, rc, tmp_path, delta_params=True)
    assert rt2.restore(4) == 4
    assert [h["loss"] for h in rt2.run(2)] == [h["loss"] for h in hist][4:6]


def test_async_pipeline_resume(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rc = _rc(cfg)
    rt = _rt(cfg, rc, tmp_path, ckpt_every_steps=4, async_ckpt=True)
    rt.initialize()
    hist = rt.run(6)
    assert rt.checkpoints_taken == 1
    assert rt.ckpt.steps() == [4]
    assert rt.agent.stats["async_stages"] == 1

    rt2 = _rt(cfg, rc, tmp_path)
    assert rt2.restore(4) == 4
    hist2 = rt2.run(2)
    assert [h["loss"] for h in hist][4:6] == [h["loss"] for h in hist2]


def test_resume_wrong_arch_rejected(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(3)
    cfg2 = reduced_config(ARCHS["rwkv6-3b"])
    rt2 = _rt(cfg2, _rc(cfg2), tmp_path)
    with pytest.raises(ValueError, match="arch"):
        rt2.restore()


def test_explicit_preemption_request(tmp_path):
    cfg = reduced_config(ARCHS["qwen1.5-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path)
    rt.initialize()
    rt.run(2)
    assert rt.checkpoints_taken == 0
    rt.request_checkpoint()
    rt.run(1)
    assert rt.checkpoints_taken == 1
    assert rt.ckpt.latest_step() == 3


def test_dataset_matches_reference():
    """Batches are numpy Philox in both packages: bit-identical."""
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    jcfg = jreduced(JARCHS["qwen2-0.5b"])
    ds = SyntheticDataset(cfg, SHAPE, seed=5)
    jds = JSyntheticDataset(jcfg, JShape("smoke", 64, 2, "train"), seed=5)
    for step in (0, 17):
        a, b = ds.get_batch(step), jds.get_batch(step)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    c = SyntheticDataset.from_state(cfg, SHAPE, ds.state_dict(17))
    np.testing.assert_array_equal(c.get_batch(17)["tokens"],
                                  ds.get_batch(17)["tokens"])
    assert not np.array_equal(ds.get_batch(18)["tokens"],
                              ds.get_batch(17)["tokens"])


def test_agent_tables_serialized_into_checkpoint(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(3)
    _, extra = rt.ckpt.restore()
    assert "agent" in extra
    assert list(extra["agent"]["comms"]["comms"].values())[0] == [0]
    assert extra["run_meta"] == {"arch": "qwen2-0.5b", "shape": "smoke",
                                 "seed": 0}
    assert extra["data"] == {"seed": 0, "step": 2}


def test_runtime_runs_on_the_card_by_default(tmp_path):
    """device=None means CUDA: without a card the entry points refuse
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        MANARuntime(cfg, _rc(cfg), ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(str(tmp_path))


def test_corrupt_chunk_is_refused(tmp_path):
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2)
    rt.initialize()
    rt.run(2)
    d = rt.ckpt.step_dir(2)
    name = next(f for f in os.listdir(d) if f.startswith("params.ln_f"))
    raw = bytearray(open(os.path.join(d, name), "rb").read())
    raw[5] ^= 1
    open(os.path.join(d, name), "wb").write(bytes(raw))
    with pytest.raises(ImageIntegrityError):
        rt.ckpt.restore(2)


# ---------------------------------------------------------------------------
# images across packages
# ---------------------------------------------------------------------------

def _jax_run(d, steps=4, arch="qwen2-0.5b", **kw):
    jcfg = jreduced(JARCHS[arch])
    jrt = JMANARuntime(jcfg, _jrc(jcfg, **kw), ckpt_dir=str(d),
                       ckpt_every_steps=2, delta_params=True,
                       quantize_moments=True)
    jrt.initialize()
    hist = jrt.run(steps)
    live = _flat(jax.tree.map(np.asarray, jrt.state))
    jrt.close()
    return hist, live


def test_jax_image_restores_in_port(tmp_path):
    """A JAX MANARuntime image (step 4: XOR delta on 2, int8 moments)
    restores in the port: digests verified, params and step exact, the
    moments exactly what the JAX manager decodes; the port then resumes
    within float32 tolerance of the JAX run."""
    _check_jax_image_restores_in_port(tmp_path, "qwen2-0.5b")


def test_jax_hybrid_image_restores_in_port(tmp_path):
    """The same for reduced hymba-1.5b."""
    _check_jax_image_restores_in_port(tmp_path, "hymba-1.5b")


def test_jax_rwkv_image_restores_in_port(tmp_path):
    """The same for reduced rwkv6-3b."""
    _check_jax_image_restores_in_port(tmp_path, "rwkv6-3b")


def test_jax_encdec_image_restores_in_port(tmp_path):
    """The same for reduced whisper-large-v3."""
    _check_jax_image_restores_in_port(tmp_path, "whisper-large-v3")


def test_jax_vision_image_restores_in_port(tmp_path):
    """The same for reduced llama-3.2-vision-11b."""
    _check_jax_image_restores_in_port(tmp_path, "llama-3.2-vision-11b")


def _check_jax_image_restores_in_port(tmp_path, arch):
    hist, live = _jax_run(tmp_path, steps=6, arch=arch, dtype="float32")
    want, jextra = JCheckpointManager(str(tmp_path)).restore(4)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    got, extra = mgr.restore(4)
    assert extra == jextra
    want, got = _flat(want), _flat(state_to_numpy(got))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and got[path].shape == arr.shape
        np.testing.assert_array_equal(got[path], arr, err_msg=path)
    if arch == "hymba-1.5b":
        assert "params/blocks/mamba/A_log" in got
    if arch == "rwkv6-3b":
        assert {"params/blocks/tm/u", "opt/v/blocks/cm/wck"} <= set(got)
    if arch == "whisper-large-v3":
        assert {"params/enc_blocks/attn/wq", "params/enc_ln_f",
                "opt/m/blocks/xattn/wk", "params/blocks/lnx"} <= set(got)
    if arch == "llama-3.2-vision-11b":
        assert {"params/self_blocks/attn/wq", "opt/v/cross_blocks/xattn/wk",
                "params/cross_blocks/lnx"} <= set(got)

    cfg = reduced_config(ARCHS[arch])
    rt = _rt(cfg, _rc(cfg, dtype="float32"), tmp_path)
    assert rt.restore(4) == 4
    resumed = [h["loss"] for h in rt.run(2)]
    want = [h["loss"] for h in hist][4:6]
    np.testing.assert_allclose(resumed[0], want[0], rtol=1e-4)
    # step 5 follows one update from each package's own step-4 gradient;
    # enc-dec encoder gradients and vision gradients agree to 1e-3 of
    # their norm only
    np.testing.assert_allclose(
        resumed[1], want[1],
        rtol=1e-3 if cfg.enc_dec or cfg.cross_attn_every else 1e-4)


def test_port_image_restores_in_jax(tmp_path):
    """A port MANARuntime image (step 4: XOR delta on 2, int8 moments)
    restores in the JAX CheckpointManager with verify=True: params and
    step equal the port's live state, every array equals the port's own
    restore, and every manifest digest is checksum_np of its file."""
    _check_port_image_restores_in_jax(tmp_path, "qwen2-0.5b")


def test_port_hybrid_image_restores_in_jax(tmp_path):
    """The same for reduced hymba-1.5b."""
    _check_port_image_restores_in_jax(tmp_path, "hymba-1.5b")


def test_port_rwkv_image_restores_in_jax(tmp_path):
    """The same for reduced rwkv6-3b."""
    _check_port_image_restores_in_jax(tmp_path, "rwkv6-3b")


def test_port_encdec_image_restores_in_jax(tmp_path):
    """The same for reduced whisper-large-v3."""
    _check_port_image_restores_in_jax(tmp_path, "whisper-large-v3")


def test_port_vision_image_restores_in_jax(tmp_path):
    """The same for reduced llama-3.2-vision-11b."""
    _check_port_image_restores_in_jax(tmp_path, "llama-3.2-vision-11b")


def _check_port_image_restores_in_jax(tmp_path, arch):
    cfg = reduced_config(ARCHS[arch])
    rt = _rt(cfg, _rc(cfg), tmp_path, ckpt_every_steps=2, delta_params=True,
             quantize_moments=True)
    rt.initialize()
    rt.run(4)
    live = _flat(state_to_numpy(rt.state))
    ours = _flat(state_to_numpy(rt.ckpt.restore(4)[0]))
    theirs, extra = JCheckpointManager(str(tmp_path), verify=True).restore(4)
    theirs = _flat(theirs)
    assert sorted(theirs) == sorted(ours)
    for path, arr in theirs.items():
        np.testing.assert_array_equal(arr, ours[path], err_msg=path)
        if not path.startswith("opt/m/") and not path.startswith("opt/v/"):
            np.testing.assert_array_equal(arr, live[path], err_msg=path)
    assert extra["run_meta"]["arch"] == arch
    with open(os.path.join(rt.ckpt.step_dir(4), "manifest.json")) as f:
        man = json.load(f)
    assert man["arrays"]["params/ln_f"]["base_step"] == 2
    assert man["arrays"]["opt/m/ln_f"]["encoding"] == "int8_block"
    for entry in man["arrays"].values():
        for fm in entry["files"]:
            data = np.fromfile(os.path.join(rt.ckpt.step_dir(4), fm["file"]),
                               np.uint8)
            assert checksum_np(data) == fm["checksum"]


def test_same_state_writes_identical_images(tmp_path):
    """One state, written by both managers with the same codec stack
    (delta params, int8 moments): identical manifests (but for the
    timestamp) and identical chunk files, at a full and a delta step."""
    _, live = _jax_run(tmp_path / "src", steps=2)
    tree = {}
    for path, arr in live.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = arr
    kw = dict(delta_keys=("params",), quantize_keys=("opt/m", "opt/v"))
    jmgr = JCheckpointManager(str(tmp_path / "jax"), **kw)
    mgr = CheckpointManager(str(tmp_path / "port"), device="cpu", **kw)
    bumped = jax.tree.map(lambda a: a + 1 if a.dtype == np.float32 else a,
                          tree)
    for step, state in ((1, tree), (2, bumped)):
        jmgr.save(step, state, extra={"k": step})
        mgr.save(step, state_from_numpy(state, "cpu"), extra={"k": step})
    for step in (1, 2):
        dj, dp = jmgr.step_dir(step), mgr.step_dir(step)
        mj, mp = (json.load(open(os.path.join(x, "manifest.json")))
                  for x in (dj, dp))
        mj.pop("written_at"), mp.pop("written_at")
        assert mp == mj
        for name in os.listdir(dj):
            if name == "manifest.json":
                continue
            assert open(os.path.join(dp, name), "rb").read() == \
                open(os.path.join(dj, name), "rb").read(), name


# ---------------------------------------------------------------------------
# decode-state images across packages (bf16 caches, 0-d int32 pos)
# ---------------------------------------------------------------------------

def _jax_decode_states(n=2, arch="mixtral-8x7b"):
    """Reduced Mixtral (MoE + SWA), hymba (hybrid SSM + SWA), rwkv6-3b
    (attention-free), whisper or vision: the JAX package's decode
    states after prefill + 1 and prefill + 2 decode steps, and its numpy
    params."""
    import jax.numpy as jnp

    from repro.models import transformer as jT
    from repro.training.step import make_serve_steps as jmake

    jcfg = jreduced(JARCHS[arch])
    jrc = JRunConfig(model=jcfg, shape=JShape("s", 64, 2, "prefill"),
                     loss_chunk=32, attn_chunk=16)
    params, _ = jT.init_params(jcfg, jax.random.PRNGKey(0))
    prefill, serve = (jax.jit(f) for f in jmake(jcfg, jrc, None))
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 66))
    _, st = prefill(params, {k: jnp.asarray(v) for k, v in
                             _prompt(jcfg, toks[:, :64]).items()})
    states = []
    for i in range(n):
        _, st = serve(params, st, jnp.asarray(toks[:, 64 + i:65 + i],
                                              jnp.int32))
        states.append(jax.tree.map(np.asarray, st))
    return jT.decode_state_logical(jcfg), states, jax.tree.map(np.asarray,
                                                               params)


def _prompt(cfg, toks):
    """A prefill batch: int32 tokens, and for enc-dec models (B, Te, d)
    f32 stub frames, for vision models (B, Tv, d) f32 stub patches, from a
    numpy seed."""
    batch = {"tokens": np.asarray(toks, np.int32)}
    if cfg.enc_dec:
        batch["frames"] = np.random.RandomState(6).randn(
            len(toks), cfg.enc_positions, cfg.d_model).astype(np.float32)
    if cfg.cross_attn_every:
        batch["patches"] = np.random.RandomState(6).randn(
            len(toks), cfg.vision_tokens, cfg.d_model).astype(np.float32)
    return batch


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_decode_state(got, want):
    """got: the port's tensors; want: numpy (bf16 as ml_dtypes).  Every
    cache leaf is bf16 (whisper's cross K/V too) but hymba's SSM state
    and rwkv's `la` state, f32."""
    ours = state_to_numpy(got)
    assert ours["pos"].shape == () and ours["pos"].dtype == np.int32
    assert int(ours["pos"]) == int(want["pos"])
    assert sorted(got["layers"]) == sorted(want["layers"])
    for key in got["layers"]:
        dt = "float32" if key in ("ssm", "la") else "bfloat16"
        assert got["layers"][key].dtype.__str__() == f"torch.{dt}"
        assert np.asarray(want["layers"][key]).dtype.name == dt
        np.testing.assert_array_equal(ours["layers"][key],
                                      _bits(want["layers"][key]))


def test_jax_decode_image_restores_in_port(tmp_path):
    """JAX images of a decode state (full, then an XOR delta on it)
    restore in the port bit for bit: bf16 caches and the 0-d pos."""
    _check_jax_decode_image_restores_in_port(tmp_path, "mixtral-8x7b")


def test_jax_hybrid_decode_image_restores_in_port(tmp_path):
    """The same for reduced hymba: its SSM state and conv tail too."""
    _check_jax_decode_image_restores_in_port(tmp_path, "hymba-1.5b")


def test_jax_rwkv_decode_image_restores_in_port(tmp_path):
    """The same for reduced rwkv6-3b: its `la` state (f32) and token-shift
    states (bf16), and no K/V."""
    _check_jax_decode_image_restores_in_port(tmp_path, "rwkv6-3b")


def test_jax_encdec_decode_image_restores_in_port(tmp_path):
    """The same for reduced whisper-large-v3: its cross K/V (`xk`, `xv`)
    too, whose delta between the two images is all zero bytes."""
    _check_jax_decode_image_restores_in_port(tmp_path, "whisper-large-v3")


def test_jax_vision_decode_image_restores_in_port(tmp_path):
    """The same for reduced llama-3.2-vision-11b: its (G, per-1, B, T, K,
    hd) self K/V and (G, B, Tv, K, hd) cross K/V."""
    _check_jax_decode_image_restores_in_port(tmp_path,
                                             "llama-3.2-vision-11b")


def _check_jax_decode_image_restores_in_port(tmp_path, arch):
    logical, states, _ = _jax_decode_states(arch=arch)
    jmgr = JCheckpointManager(str(tmp_path), delta_keys=("decode",))
    for step, st in enumerate(states, 1):
        jmgr.save(step, {"decode": st}, {"decode": logical})
    with open(os.path.join(jmgr.step_dir(2), "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    cache = "shift_a" if "la" in logical["layers"] else "k"
    assert arrays[f"decode/layers/{cache}"]["dtype"] == "bfloat16"
    assert arrays[f"decode/layers/{cache}"]["base_step"] == 1
    assert arrays["decode/pos"]["shape"] == []
    if "xk" in logical["layers"]:
        assert arrays["decode/layers/xk"]["base_step"] == 1
        np.testing.assert_array_equal(_bits(states[0]["layers"]["xk"]),
                                      _bits(states[1]["layers"]["xk"]))
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    for step, st in enumerate(states, 1):
        got, _ = mgr.restore(step)
        _assert_same_decode_state(got["decode"], st)


def test_port_decode_image_restores_in_jax(tmp_path):
    """The port's images of its own decode state (same params and
    tokens) restore in the JAX manager with verify=True bit for bit, and
    the JAX package decodes on from the restored state."""
    _check_port_decode_image_restores_in_jax(tmp_path, "mixtral-8x7b")


def test_port_hybrid_decode_image_restores_in_jax(tmp_path):
    """The same for reduced hymba: its SSM state and conv tail too."""
    _check_port_decode_image_restores_in_jax(tmp_path, "hymba-1.5b")


def test_port_rwkv_decode_image_restores_in_jax(tmp_path):
    """The same for reduced rwkv6-3b: its `la` and token-shift states."""
    _check_port_decode_image_restores_in_jax(tmp_path, "rwkv6-3b")


def test_port_encdec_decode_image_restores_in_jax(tmp_path):
    """The same for reduced whisper-large-v3: its cross K/V too."""
    _check_port_decode_image_restores_in_jax(tmp_path, "whisper-large-v3")


def test_port_vision_decode_image_restores_in_jax(tmp_path):
    """The same for reduced llama-3.2-vision-11b."""
    _check_port_decode_image_restores_in_jax(tmp_path,
                                             "llama-3.2-vision-11b")


def _check_port_decode_image_restores_in_jax(tmp_path, arch):
    import jax.numpy as jnp

    from repro.models import transformer as jT
    from repro_torch.models.transformer import decode_state_logical
    from repro_torch.training.step import make_serve_steps

    logical, _, params = _jax_decode_states(n=0, arch=arch)
    assert decode_state_logical(reduced_config(ARCHS[arch])) == logical
    cfg = reduced_config(ARCHS[arch])
    rc = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "prefill"),
                   loss_chunk=32, attn_chunk=16)
    prefill, serve = make_serve_steps(cfg, rc)
    tparams = state_from_numpy(params, "cpu")
    import torch

    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 66)).astype(np.int32))
    _, st = prefill(tparams, {k: torch.from_numpy(v) for k, v in
                              _prompt(cfg, toks[:, :64].numpy()).items()})
    mgr = CheckpointManager(str(tmp_path), delta_keys=("decode",),
                            device="cpu")
    states = []
    for i in range(2):
        _, st = serve(tparams, st, toks[:, 64 + i:65 + i])
        states.append(st)
        mgr.save(i + 1, {"decode": st}, {"decode": decode_state_logical(cfg)})
    jmgr = JCheckpointManager(str(tmp_path), verify=True)
    for step, st in enumerate(states, 1):
        theirs, _ = jmgr.restore(step)
        _assert_same_decode_state(st, theirs["decode"])
    jcfg = jreduced(JARCHS[arch])
    jrc = JRunConfig(model=jcfg, shape=JShape("s", 64, 2, "prefill"),
                     loss_chunk=32, attn_chunk=16)
    dec = jax.tree.map(jnp.asarray, theirs["decode"])
    jl, jst = jT.decode_step(jax.tree.map(jnp.asarray, params), jcfg, jrc,
                             None, dec, jnp.asarray(toks[:, 65:66].numpy()))
    tl, _ = serve(tparams, states[-1], toks[:, 65:66])
    assert int(jst["pos"]) == 67
    a, b = tl.float().numpy(), np.asarray(jl, np.float32)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2


def test_same_decode_state_writes_identical_images(tmp_path):
    """One decode state, written by both managers with XOR-delta decode
    images: identical manifests (but for the timestamp) and identical
    chunk files, at the full and at the delta step."""
    _check_same_decode_state_writes_identical_images(tmp_path, "mixtral-8x7b")


def test_same_hybrid_decode_state_writes_identical_images(tmp_path):
    """The same for reduced hymba: `state_from_numpy` carries its f32 SSM
    state and bf16 conv tail as they are."""
    _check_same_decode_state_writes_identical_images(tmp_path, "hymba-1.5b")


def test_same_rwkv_decode_state_writes_identical_images(tmp_path):
    """The same for reduced rwkv6-3b."""
    _check_same_decode_state_writes_identical_images(tmp_path, "rwkv6-3b")


def test_same_encdec_decode_state_writes_identical_images(tmp_path):
    """The same for reduced whisper-large-v3."""
    _check_same_decode_state_writes_identical_images(tmp_path,
                                                     "whisper-large-v3")


def test_same_vision_decode_state_writes_identical_images(tmp_path):
    """The same for reduced llama-3.2-vision-11b."""
    _check_same_decode_state_writes_identical_images(
        tmp_path, "llama-3.2-vision-11b")


def _check_same_decode_state_writes_identical_images(tmp_path, arch):
    logical, states, _ = _jax_decode_states(arch=arch)
    jmgr = JCheckpointManager(str(tmp_path / "jax"), delta_keys=("decode",))
    mgr = CheckpointManager(str(tmp_path / "port"), delta_keys=("decode",),
                            device="cpu")
    for step, st in enumerate(states, 1):
        jmgr.save(step, {"decode": st}, {"decode": logical})
        mgr.save(step, {"decode": state_from_numpy(st, "cpu")},
                 {"decode": logical})
    for step in (1, 2):
        dj, dp = jmgr.step_dir(step), mgr.step_dir(step)
        mj, mp = (json.load(open(os.path.join(x, "manifest.json")))
                  for x in (dj, dp))
        mj.pop("written_at"), mp.pop("written_at")
        assert mp == mj
        names = sorted(os.listdir(dj))
        assert names == sorted(os.listdir(dp))
        for name in names:
            if name != "manifest.json":
                assert open(os.path.join(dp, name), "rb").read() == \
                    open(os.path.join(dj, name), "rb").read(), name
