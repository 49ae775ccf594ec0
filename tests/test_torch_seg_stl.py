"""The segmentation STL tree (``voxel_to_mesh.export_seg_stl_tree``), its
ingest (``offline.build_seg_cache``) and the two commands
(``cli export-stl-data --seg``, ``cli build-cache`` on a segment tree),
the port against the JAX package on the CPU.

Every comparison is bitwise: the tree is written by the same numpy draws,
mesh extraction and STL writer; the ingest voxelizes each mesh
unnormalized through the port's native voxelizer, which
``tests/test_torch_native.py`` holds bitwise to the numpy path (the JAX
package runs its numpy path here, never its own native build), so its
shards equal ``export_seg_cache``'s of the same arguments byte for byte,
the reference's own contract (``tests/test_offline.py``).

Sizes: R=16, 12 parts in shards of 5.
"""

import json
import os

import numpy as np
import pytest

from featurenet_tpu.data import offline as jax_offline
from featurenet_tpu.data import voxel_to_mesh as jax_v2m
from featurenet_tpu_torch import cli
from featurenet_tpu_torch.data import offline, voxel_to_mesh

R = 16
KW = dict(num_parts=12, resolution=R, num_features=3, shard_size=5, seed=4)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segstl") / "tree")
    voxel_to_mesh.export_seg_stl_tree(root, **KW)
    return root


@pytest.mark.parametrize("label_order", ["canonical", "generation"])
def test_export_seg_stl_tree_is_bitwise_the_reference(tmp_path, label_order):
    kw = dict(KW, num_parts=6, label_order=label_order)
    got = voxel_to_mesh.export_seg_stl_tree(str(tmp_path / "t"), **kw)
    want = jax_v2m.export_seg_stl_tree(str(tmp_path / "j"), **kw)
    assert got == want and got["kind"] == "segment_stl" and got["aligned_unit_cube"]
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(os.listdir(str(tmp_path / "t" / "parts"))) == 12
    seg = np.load(str(tmp_path / "t" / "parts" / "part_0000000.seg.npy"))
    assert seg.dtype == np.int8 and seg.shape == (R, R, R)


def test_build_seg_cache_is_export_seg_cache_whatever_the_workers(tree, tmp_path):
    ref = str(tmp_path / "ref")
    exported = offline.export_seg_cache(ref, **{k: v for k, v in KW.items()})
    for workers in (1, 2):
        out = str(tmp_path / f"w{workers}")
        index = offline.build_seg_cache(tree, out, workers=workers)
        assert index["shards"] == exported["shards"] == [
            {"stem": "seg_0000", "count": 5}, {"stem": "seg_0001", "count": 5},
            {"stem": "seg_0002", "count": 2}]
        assert (index["kind"], index["resolution"], index["num_features"]) == \
            ("segment", R, 3)
        for sh in index["shards"]:
            for kind in ("voxels", "seg"):
                name = f"{sh['stem']}.{kind}.npy"
                with open(os.path.join(out, name), "rb") as a, \
                        open(os.path.join(ref, name), "rb") as b:
                    assert a.read() == b.read(), (workers, name)
    want = jax_offline.build_seg_cache(tree, str(tmp_path / "jax"), workers=1,
                                       backend="numpy")
    got = offline.build_seg_cache(tree, str(tmp_path / "again"), workers=1)
    assert {k: v for k, v in got.items() if k != "source"} == \
        {k: v for k, v in want.items() if k != "source"}
    assert got["source"]["label_order"] == want["source"]["label_order"]
    # The ingested cache trains through the segmentation dataset.
    ds = offline.SegCacheDataset(str(tmp_path / "w1"), global_batch=4)
    batch = next(ds.worker_iter(0))
    assert batch["seg"].shape == (4, R, R, R) and batch["voxels"].shape == (4, R, R, R // 8)


def _copy_tree(src, dst, index=None):
    import shutil

    shutil.copytree(src, dst)
    if index is not None:
        with open(os.path.join(dst, "index.json"), "w") as fh:
            json.dump(index, fh)
    return dst


def test_build_seg_cache_refusals(tree, tmp_path):
    with open(os.path.join(tree, "index.json")) as fh:
        index = json.load(fh)
    misaligned = _copy_tree(tree, str(tmp_path / "mis"),
                            {k: v for k, v in index.items() if k != "aligned_unit_cube"})
    with pytest.raises(ValueError, match="aligned_unit_cube"):
        offline.build_seg_cache(misaligned, str(tmp_path / "o1"), workers=1)
    cls_tree = str(tmp_path / "cls")
    os.makedirs(os.path.join(cls_tree, "o_ring"))
    with open(os.path.join(cls_tree, "index.json"), "w") as fh:
        json.dump({"kind": "classify"}, fh)
    with pytest.raises(ValueError, match="not a segmentation STL tree"):
        offline.build_seg_cache(cls_tree, str(tmp_path / "o2"), workers=1)
    shape = _copy_tree(tree, str(tmp_path / "shape"))
    np.save(os.path.join(shape, "parts", "part_0000003.seg.npy"),
            np.zeros((R, R, R // 2), np.int8))
    with pytest.raises(ValueError, match="sidecar shape"):
        offline.build_seg_cache(shape, str(tmp_path / "o3"), workers=1)
    occupied = _copy_tree(tree, str(tmp_path / "occ"))
    seg = np.load(os.path.join(occupied, "parts", "part_0000002.seg.npy"))
    seg[R // 2, R // 2, R // 2] = 3  # the stock's centre: occupied
    np.save(os.path.join(occupied, "parts", "part_0000002.seg.npy"), seg)
    with pytest.raises(ValueError, match="misaligned"):
        offline.build_seg_cache(occupied, str(tmp_path / "o4"), workers=1)
    for root, match in ((misaligned, "aligned_unit_cube"),
                        (occupied, "misaligned")):
        with pytest.raises(ValueError, match=match):
            jax_offline.build_seg_cache(root, str(tmp_path / "j"), workers=1,
                                        backend="numpy")


def _main(capsys, *args):
    assert cli.main(list(args)) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_cli_export_stl_data_seg_and_build_cache(tmp_path, capsys):
    out = str(tmp_path / "tree")
    rec = _main(capsys, "export-stl-data", "--seg", "--out", out, "--num-parts",
                "12", "--resolution", str(R), "--seed", "4", "--num-features", "3")
    assert rec == [{"exported": 12, "kind": "segment_stl"}]
    with open(os.path.join(out, "index.json")) as fh:
        index = json.load(fh)
    assert index["shard_size"] == 200 and index["label_order"] == "canonical"
    jax_v2m.export_seg_stl_tree(str(tmp_path / "jtree"), num_parts=12,
                                resolution=R, seed=4)
    _same_tree(out, str(tmp_path / "jtree"))
    rec = _main(capsys, "build-cache", "--stl-root", out, "--out",
                str(tmp_path / "c"), "--workers", "1")
    assert rec[0]["built"] == 12 and rec[0]["kind"] == "segment"
    assert rec[0]["seconds"] > 0
    ref = str(tmp_path / "ref")
    _main(capsys, "export-seg-data", "--out", ref, "--num-parts", "12",
          "--resolution", str(R), "--seed", "4")
    for kind in ("voxels", "seg"):
        with open(os.path.join(str(tmp_path / "c"), f"seg_0000.{kind}.npy"), "rb") as a, \
                open(os.path.join(ref, f"seg_0000.{kind}.npy"), "rb") as b:
            assert a.read() == b.read()
    # A resolution that agrees with the tree is accepted; one that
    # contradicts it is refused before anything is written.
    _main(capsys, "build-cache", "--stl-root", out, "--out",
          str(tmp_path / "c2"), "--workers", "1", "--resolution", str(R))
    with pytest.raises(SystemExit, match="contradicts"):
        cli.main(["build-cache", "--stl-root", out, "--out",
                  str(tmp_path / "c3"), "--resolution", "32"])
    assert not os.path.exists(str(tmp_path / "c3"))
    with pytest.raises(SystemExit, match="contradicts"):
        cli.main(["build-cache", "--stl-root", out, "--out",
                  str(tmp_path / "c4"), "--resolution", "64"])


def test_cli_build_cache_of_a_class_tree_defaults_to_64(tmp_path, capsys):
    """Without ``--resolution`` a classification tree builds at 64, as
    before."""
    import shutil

    tree = str(tmp_path / "cls")
    voxel_to_mesh.export_stl_tree(tree, per_class=1, resolution=R, seed=2)
    for cls in os.listdir(tree):
        if cls != "o_ring":
            shutil.rmtree(os.path.join(tree, cls))
    rec = _main(capsys, "build-cache", "--stl-root", tree, "--out",
                str(tmp_path / "c"), "--workers", "1")
    assert rec[0]["built"] == {"o_ring": 1}
    with open(os.path.join(str(tmp_path / "c"), "index.json")) as fh:
        assert json.load(fh)["resolution"] == 64
    assert np.load(os.path.join(str(tmp_path / "c"), "o_ring.npy")).shape == (1, 64, 64, 8)
