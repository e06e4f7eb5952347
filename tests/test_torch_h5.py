"""The port's HDF5 episode loader (`data/hdf5.py`, `H5EpisodeDataset`,
`setup_env`'s `h5:` names) against neko_tpu's, which reads through h5py:

* files that neko_tpu's `save_h5` writes from `collect_expert_dataset` on
  each synthetic env it can save (`neko-synth-text-v0`'s '<U4' actions have
  no HDF5 type there), and one of 300 episodes (a group B-tree of more than
  one level): every episode equal array for array, dtypes included;
* files h5py writes directly: chunked with edge chunks (and never written),
  compact, big-endian int32 and float64, float16, a zero-length dataset,
  an unwritten contiguous one (its fill value), a scalar, attributes;
  a file of another libver raises;
* gzip, shuffle and bool (enum) datasets raise, naming the feature;
* `ControlTask` on `h5:<path>:<EnvId>` and on a bare `.h5` path samples the
  same examples as neko_tpu's; a non-synth env id raises, naming it;
* four threads reading one file at once read what one thread reads;
* the committed fixtures (`tests/torch_fixtures/`, what the card reads:
  it has no h5py) equal what `write_fixtures` regenerates with neko_tpu.

`python -m tests.test_torch_h5` rewrites the fixtures.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from neko_tpu.data.episodes import H5EpisodeDataset as JaxH5  # noqa: E402
from neko_tpu.data.episodes import save_h5  # noqa: E402
from neko_tpu.envs import setup_env as jax_setup_env  # noqa: E402
from neko_tpu.envs import synthetic as jax_synthetic  # noqa: E402
from neko_tpu.tasks.control import ControlTask as JaxControlTask  # noqa: E402

from neko_tpu_torch.data.episodes import H5EpisodeDataset  # noqa: E402
from neko_tpu_torch.data.hdf5 import H5File, UnsupportedHDF5  # noqa: E402
from neko_tpu_torch.envs import setup_env  # noqa: E402
from neko_tpu_torch.tasks.control import ControlTask  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures")
# the committed fixtures: (env id, episodes), expert rollouts from seed 0
FIXTURE_SPECS = (("neko-synth-continuous-v0", 8), ("neko-synth-dict-v0", 8))
SAVABLE = ["neko-synth-continuous-v0", "neko-synth-discrete-v0", "neko-synth-image-v0",
           "neko-synth-multidiscrete-v0", "neko-synth-dict-v0", "neko-synth-dictact-v0"]


def write_fixture(name: str, n_episodes: int, path: str, **env_kw) -> None:
    """neko_tpu's expert rollouts of `name` (seed 0) through its save_h5."""
    env = jax_synthetic.SYNTHETIC_SPECS[name](env_kw)
    ds = jax_synthetic.collect_expert_dataset(env, n_episodes=n_episodes, seed=0, env_id=name)
    save_h5(path, ds.get_episodes(range(n_episodes)), env_id=name)


def write_fixtures(directory: str = FIXTURES) -> None:
    os.makedirs(directory, exist_ok=True)
    for name, n in FIXTURE_SPECS:
        write_fixture(name, n, os.path.join(directory, f"{name}.h5"))


def _equal(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _equal(got[k], want[k], f"{where}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


def _same_datasets(path):
    got, want = H5EpisodeDataset(path), JaxH5(path)
    assert len(got) == len(want) and got.spec_env_id == want.spec_env_id
    for i in range(len(want)):
        g, w = got.get_episode(i), want.get_episode(i)
        for field in ("observations", "actions", "rewards"):
            _equal(getattr(g, field), getattr(w, field), f"episode {i} {field}")
    got.close()
    want.close()


@pytest.mark.parametrize("name", SAVABLE)
def test_save_h5_files_read_as_neko_tpu_reads_them(tmp_path, name):
    path = str(tmp_path / f"{name}.h5")
    write_fixture(name, 3, path)
    _same_datasets(path)


def test_three_hundred_episodes_walk_a_deep_group_btree(tmp_path):
    path = str(tmp_path / "many.h5")
    write_fixture("neko-synth-discrete-v0", 300, path, horizon=2)
    with H5File(path) as f:  # more than 8 x 32 links: the root's B-tree has levels
        assert len(f.root.links) == 300
    _same_datasets(path)


def _walk(node, ref, where=""):
    assert set(node.keys()) == set(ref.keys()), where
    for k, v in ref.attrs.items():
        got = node.attrs[k]
        assert (got == v) if isinstance(v, str) else np.array_equal(got, v), (where, k)
    for k in ref.keys():
        if isinstance(ref[k], h5py.Group):
            _walk(node[k], ref[k], f"{where}/{k}")
        else:
            _equal(node[k].read(), np.asarray(ref[k]), f"{where}/{k}")


def test_layouts_and_types_h5py_writes(tmp_path):
    path = str(tmp_path / "layouts.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=np.arange(35, dtype=np.float32).reshape(7, 5),
                         chunks=(3, 2))
        f.create_dataset("chunked_1d", data=np.arange(10, dtype=np.int16), chunks=(4,),
                         maxshape=(None,))
        f.create_dataset("chunked_unwritten", shape=(5,), dtype=np.int32, chunks=(2,),
                         fillvalue=7)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        f.create_dataset("compact", data=np.arange(6, dtype=np.int64).reshape(2, 3), dcpl=dcpl)
        f.create_dataset("big_endian_i4", data=np.arange(-3, 5, dtype=">i4"))
        f.create_dataset("big_endian_f8", data=np.linspace(-1, 1, 7).astype(">f8"))
        f.create_dataset("f16", data=np.linspace(0, 2, 5).astype(np.float16))
        f.create_dataset("u8", data=np.arange(200, 205, dtype=np.uint8))
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        f.create_dataset("unwritten", shape=(3, 2), dtype=np.float32, fillvalue=2.5)
        f.create_dataset("scalar", data=np.float64(3.5))
        g = f.create_group("nested/deeper")
        g.create_dataset("x", data=np.arange(4, dtype=np.int8))
        g.attrs["note"] = "vlen"
        f.attrs["vector"] = np.arange(3)
        f.attrs["total_episodes"] = 0
    with H5File(path) as got, h5py.File(path, "r") as want:
        _walk(got.root, want)
        assert got["chunked"].read().flags.writeable


@pytest.mark.parametrize("kind,feature", [("gzip", "gzip"), ("shuffle", "shuffle"),
                                          ("bool", "enum")])
def test_unsupported_features_raise_naming_themselves(tmp_path, kind, feature):
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w") as f:
        if kind == "gzip":
            f.create_dataset("x", data=np.arange(100), compression="gzip")
        elif kind == "shuffle":
            f.create_dataset("x", data=np.arange(100), shuffle=True, chunks=(10,))
        else:
            f.create_dataset("x", data=np.arange(10) % 2 == 0)
    with pytest.raises(UnsupportedHDF5, match=feature), H5File(path) as f:
        f["x"].read()
    newer = str(tmp_path / "newer.h5")
    with h5py.File(newer, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(UnsupportedHDF5, match="superblock version"):
        H5File(newer)


def _task_pair(dataset_name):
    kw = dict(context_len=64, seed=5)
    jenv, jds = jax_setup_env.load_env_dataset(dataset_name)
    env, ds = setup_env.load_env_dataset(dataset_name)
    assert isinstance(ds, H5EpisodeDataset)
    return (JaxControlTask("h5", jenv, jds, **kw), ControlTask("h5", env, ds, **kw))


@pytest.mark.parametrize("form", ["h5:{path}:neko-synth-continuous-v0", "{path}"])
def test_control_task_on_an_h5_file_samples_as_neko_tpu(tmp_path, form):
    from tests.test_torch_tasks import _equal_examples

    path = str(tmp_path / "cont.h5")
    write_fixture("neko-synth-continuous-v0", 6, path)
    jtask, task = _task_pair(form.format(path=path))
    for vanilla, prompted in ((3, {}), (1, {"end": 2, "uniform": 1})):
        _equal_examples(task.sample_batch(vanilla, prompted, max_tokens=64),
                        jtask.sample_batch(vanilla, prompted, max_tokens=64))


def test_env_ids_the_port_cannot_make_raise(tmp_path):
    path = str(tmp_path / "cont.h5")
    write_fixture("neko-synth-continuous-v0", 2, path)
    with pytest.raises(NotImplementedError, match="CartPole-v1.*gymnasium"):
        setup_env.load_env_dataset(f"h5:{path}:CartPole-v1")
    bare = str(tmp_path / "bare.h5")
    with h5py.File(bare, "w") as f:
        f.create_group("episode_0")
    with pytest.raises(ValueError, match="carries no env_id"):
        setup_env.load_env_dataset(bare)


def test_four_threads_read_one_file(tmp_path):
    path = str(tmp_path / "dict.h5")
    write_fixture("neko-synth-dict-v0", 12, path)
    ds = H5EpisodeDataset(path)
    want = [ds.get_episode(i) for i in range(len(ds))]
    errors = []

    def reader(offset):
        try:
            for r in range(5):
                for i in range(len(ds)):
                    j = (i + offset + r) % len(ds)
                    got = ds.get_episode(j)
                    for field in ("observations", "actions", "rewards"):
                        _equal(getattr(got, field), getattr(want[j], field), f"{j} {field}")
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]


def test_committed_fixtures_equal_their_regeneration(tmp_path):
    write_fixtures(str(tmp_path))
    total = 0
    for name, n in FIXTURE_SPECS:
        committed = os.path.join(FIXTURES, f"{name}.h5")
        total += os.path.getsize(committed)
        got, want = H5EpisodeDataset(committed), JaxH5(str(tmp_path / f"{name}.h5"))
        assert len(got) == len(want) == n and got.spec_env_id == name
        for i in range(n):
            for field in ("observations", "actions", "rewards"):
                _equal(getattr(got.get_episode(i), field), getattr(want.get_episode(i), field),
                       f"{name} {i} {field}")
    assert total < 200_000


if __name__ == "__main__":
    write_fixtures()
