"""The port's native C packer (`neko_tpu_torch/native/`) and its HDF5 writer
(`data/episodes.save_h5` over `data/hdf5.write_h5`) against neko_tpu's:

* the C kernel against the port's numpy route and against neko_tpu's packer
  (its C kernel and its numpy route) on the cases of
  tests/test_native_packing.py, tokens, targets and inner positions bit for
  bit; `SequencePacker.pack_example` sends the three pure-control key sets
  there and nothing else (text, `observation_loss`, other keys, an episode
  longer than the context), counted in `native.calls`; a compiler that
  fails raises with its output;
* `save_h5` files read back three ways -- by h5py, by neko_tpu's
  `H5EpisodeDataset` and by the port's reader -- equal to the episodes
  written, arrays, dtypes and the `total_episodes` / `env_id` attributes,
  dict observations and actions included, for every synthetic env whose
  arrays have an HDF5 type, and 300 episodes (a group B-tree with levels);
  h5py reads the same datasets and attributes from the port's file as from
  neko_tpu's `save_h5` of the same episodes, and the port's reader reads
  neko_tpu's; bool and string arrays raise, naming themselves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.episodes import H5EpisodeDataset as JaxH5  # noqa: E402
from neko_tpu.data.episodes import save_h5 as jax_save_h5  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402

from neko_tpu_torch import native  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.episodes import Episode, H5EpisodeDataset, save_h5  # noqa: E402
from neko_tpu_torch.data.hdf5 import UnsupportedHDF5  # noqa: E402
from neko_tpu_torch.data.packing import SequencePacker  # noqa: E402
from neko_tpu_torch.envs import synthetic  # noqa: E402

WIDTH = dict(embed_dim=32, layers=1, heads=2, context_len=512, max_patches=0,
             text_tokens=256, continuous_tokens=64, discrete_tokens=64)
CASES = [  # tests/test_native_packing.py's
    {"continuous_obs": "randn:12x8", "continuous_actions": "tanh:12x3"},
    {"continuous_obs": "bigrandn:7x5", "discrete_actions": "randint:7x1"},
    {"discrete_obs": "randint:9x2", "discrete_actions": "randint:9x1"},
]


def _example(spec):
    rng = np.random.RandomState(0)

    def mk(s):
        kind, shape = s.split(":")
        t, d = (int(x) for x in shape.split("x"))
        if kind == "randn":
            return rng.randn(t, d).astype(np.float32)
        if kind == "bigrandn":
            return (rng.randn(t, d) * 100).astype(np.float32)
        if kind == "tanh":
            x = np.tanh(rng.randn(t, d)).astype(np.float32)
            x[0, 0], x[0, -1] = 1.0, -1.0  # the unclipped top bin, the bottom edge
            return x
        return rng.randint(0, 50, (t, d)).astype(np.int32)

    return {k: mk(v) for k, v in spec.items()}


def _numpy_route(packer):
    packer._pack_control_native = lambda ex: None
    return packer


@pytest.mark.parametrize("spec", CASES, ids=["cont-cont", "cont-disc", "disc-disc"])
def test_native_packer_bit_equal_to_numpy_and_to_neko_tpu(spec):
    ex = _example(spec)
    before = native.calls
    fast = SequencePacker(ModelConfig(**WIDTH)).pack_example(ex)
    assert native.calls == before + 1
    ours = _numpy_route(SequencePacker(ModelConfig(**WIDTH))).pack_example(ex)
    theirs = [JaxPacker(JaxConfig(**WIDTH)).pack_example(ex),
              _numpy_route(JaxPacker(JaxConfig(**WIDTH))).pack_example(ex)]
    for want in [ours] + theirs:
        for field in ("tokens", "target_mask", "inner_pos"):
            got, ref = getattr(fast, field), getattr(want, field)
            assert got.dtype == ref.dtype, field
            np.testing.assert_array_equal(got, ref, err_msg=field)
    assert fast.patches.shape == ours.patches.shape and fast.patch_slot.size == 0


def test_native_packer_takes_only_pure_control_examples():
    p = SequencePacker(ModelConfig(**WIDTH))
    cont = {"continuous_obs": np.zeros((3, 2), np.float32),
            "continuous_actions": np.zeros((3, 1), np.float32)}
    assert p._pack_control_native(cont) is not None
    assert p._pack_control_native({**cont, "text": None}) is not None  # None values drop
    assert p._pack_control_native({"text": [1, 2]}) is None
    assert p._pack_control_native({**cont, "discrete_actions": np.zeros((3, 1))}) is None
    long = {"continuous_obs": np.zeros((200, 2), np.float32),
            "continuous_actions": np.zeros((200, 1), np.float32)}
    assert p._pack_control_native(long) is None  # 800 > 512 tokens: the numpy route trims
    assert p.pack_example(long).length <= 512
    q = SequencePacker(ModelConfig(**WIDTH, observation_loss=True))
    assert q._pack_control_native(cont) is None


def test_a_failing_compiler_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CC", "false")  # exits 1 at once
    with pytest.raises(native.NativeBuildError, match="failed to build packing.c"):
        native.lib()
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="cannot run the C compiler"):
        native.lib()


# ------------------------------------------------------------------ save_h5
SAVABLE = ["neko-synth-continuous-v0", "neko-synth-discrete-v0", "neko-synth-image-v0",
           "neko-synth-multidiscrete-v0", "neko-synth-dict-v0", "neko-synth-dictact-v0"]


def _episodes(name, n, **kw):
    env = synthetic.SYNTHETIC_SPECS[name](kw)
    ds = synthetic.collect_expert_dataset(env, n_episodes=n, seed=0, env_id=name)
    return ds.get_episodes(range(n))


def _equal(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _equal(got[k], want[k], f"{where}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _h5py_tree(node):
    return {k: _h5py_tree(v) if isinstance(v, h5py.Group) else v[()] for k, v in node.items()}


def _read_three_ways(path, episodes, env_id):
    with h5py.File(path, "r") as f:
        assert int(f.attrs["total_episodes"]) == len(episodes)
        assert f.attrs["total_episodes"].dtype == np.int64 and f.attrs["env_id"] == env_id
        tree = _h5py_tree(f)
    for i, ep in enumerate(episodes):
        g = tree[f"episode_{i}"]
        for field in ("observations", "actions", "rewards"):
            _equal(g[field], getattr(ep, field), f"h5py episode {i} {field}")
    for reader in (JaxH5, H5EpisodeDataset):
        ds = reader(path)
        assert len(ds) == len(episodes) and ds.spec_env_id == env_id, reader
        for i, ep in enumerate(episodes):
            got = ds.get_episode(i)
            for field in ("observations", "actions", "rewards"):
                _equal(getattr(got, field), getattr(ep, field), f"{reader} {i} {field}")
        ds.close()


@pytest.mark.parametrize("name", SAVABLE)
def test_save_h5_reads_back_three_ways(tmp_path, name):
    episodes = _episodes(name, 3)
    path = str(tmp_path / "sub" / f"{name}.h5")
    save_h5(path, episodes, env_id=name)
    _read_three_ways(path, episodes, name)


def test_save_h5_three_hundred_episodes_and_the_same_file_as_neko_tpu(tmp_path):
    episodes = _episodes("neko-synth-discrete-v0", 300, horizon=2)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    save_h5(ours, episodes, env_id="neko-synth-discrete-v0")
    jax_save_h5(theirs, episodes, env_id="neko-synth-discrete-v0")
    _read_three_ways(ours, episodes, "neko-synth-discrete-v0")
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert dict(a.attrs) == dict(b.attrs)
        ta, tb = _h5py_tree(a), _h5py_tree(b)
    assert set(ta) == set(tb) and len(ta) == 300
    for k in tb:
        _equal(ta[k], tb[k], k)
    ds = H5EpisodeDataset(theirs)  # the port's reader on neko_tpu's file, as before
    _equal(ds.get_episode(299).actions, episodes[299].actions, "neko_tpu's file")
    ds.close()


def test_save_h5_without_env_id_and_refusals(tmp_path):
    ep = Episode(observations={"a": np.zeros((3, 2), ">f8"), "b": np.arange(3, dtype=np.uint16)},
                 actions=np.zeros((2, 0), np.int8), rewards=np.ones(2, np.float16))
    path = str(tmp_path / "x.h5")
    save_h5(path, [ep])
    with h5py.File(path, "r") as f:
        assert set(f.attrs) == {"total_episodes"}
        _equal(f["episode_0/observations/a"][()], ep.observations["a"], "big-endian")
    ds = H5EpisodeDataset(path)
    assert ds.spec_env_id is None
    _equal(ds.get_episode(0).observations, ep.observations, "dict")
    _equal(ds.get_episode(0).actions, ep.actions, "zero-size")
    for bad, what in ((np.zeros(2, bool), "bool"), (np.array(["ab", "c"]), "<U2")):
        with pytest.raises(UnsupportedHDF5, match=what):
            save_h5(str(tmp_path / "bad.h5"), [Episode(bad, ep.actions, ep.rewards)])
