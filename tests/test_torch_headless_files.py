"""The port CLI's mesh-file scenes, config2, --checkpoint-every and its
handling of progressive-only flags under --pipeline realtime, against the
JAX CLI on the CPU.

A mesh file's scene is a numpy lowering of the loaded mesh, so its packs
and the camera matrices must equal the JAX CLI's bit for bit. Resuming from
a --checkpoint-every file continues the render bit for bit. The realtime
frame with the ignored flags is held against the JAX CLI's on the image
gate of benchmarks/kernel_parity.py (<= 1% of pixels off by > 1e-3, median
|d| <= 1e-5), and equals the port's own frame without the flags bit for bit.
"""

import os

import numpy as np
import pytest

import chip_smoke as cs
from dxrexperiments_torch.app import headless as thead
from dxrexperiments_torch.models import progressive as tprog
from dxrexperiments_torch.scene import mesh as tmesh
from dxrexperiments_torch.scene.procedural import sphere_mesh
from dxrexperiments_torch.utils.dds import write_dds
from dxrexperiments_tpu.app import headless as jhead

SIZE = 16


def sphere():
    base = sphere_mesh((0.3, 1.0, -0.2), 1.5, lat=8, lon=16)
    return tmesh.Mesh(base.positions, None, base.indices[:, [0, 2, 1]])


@pytest.fixture(params=["obj", "ply", "glb", "fbx"])
def mesh_file(request, tmp_path):
    path = str(tmp_path / f"sphere.{request.param}")
    {"obj": cs.write_obj, "ply": cs.write_ply, "glb": cs.write_glb,
     "fbx": cs.write_fbx}[request.param](path, sphere())
    return path


def test_mesh_file_scene_matches_jax(mesh_file):
    tsc, tcamera = thead.build_scene(mesh_file)
    jsc, jcamera = jhead.build_scene(mesh_file)
    for cam in (tcamera, jcamera):
        cam.set_aspect(SIZE, SIZE)
    np.testing.assert_array_equal(tcamera.view_proj_matrix(), jcamera.view_proj_matrix())
    np.testing.assert_array_equal(tcamera.uvw()[0], jcamera.uvw()[0])
    got, want = tsc.build("cpu"), jsc.build()
    for k in ("mt_pack", "attr_pack"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["num_tris"] == int(want["num_tris"]) == sphere().num_triangles


def test_mesh_file_cli_renders_and_matches_in_memory(tmp_path, mesh_file):
    """The CLI on the file equals the same mesh built in memory and framed
    by ``mesh_scene``, rendered through the pipeline (bit for bit)."""
    out = str(tmp_path / "cli.npy")
    assert thead.main(["--scene", mesh_file, "--size", f"{SIZE}x{SIZE}", "--spp", "2",
                       "--device", "cpu", "-o", out]) == 0
    sc, cam = thead.mesh_scene(sphere())
    cam.set_aspect(SIZE, SIZE)
    pipe = tprog.ProgressiveRaytracingPipeline(SIZE, SIZE, seed=0, device="cpu")
    pipe.max_iterations = 2
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    for f in range(2):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        pipe.render()
    got = np.load(out)
    assert got.max() > 0.0
    np.testing.assert_array_equal(got, pipe.get_output().numpy())


def test_missing_or_unknown_mesh_file_raises(tmp_path):
    """The port CLI refuses a file it cannot load (the JAX CLI renders a
    fallback triangle there)."""
    with pytest.raises(FileNotFoundError):
        thead.build_scene(str(tmp_path / "missing.obj"))
    with pytest.raises(ValueError):
        thead.build_scene("no-such-scene")
    assert jhead.build_scene(str(tmp_path / "missing.obj"))[0].instances[0].mesh.num_triangles == 1


def test_config2_names_the_missing_file(tmp_path, monkeypatch):
    monkeypatch.setattr(thead, "ASSETS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="susanne.obj"):
        thead.main(["--scene", "config2", "--size", "8x8", "--spp", "1", "--device", "cpu",
                    "-o", str(tmp_path / "c2.png")])
    os.makedirs(tmp_path / "models")
    cs.write_obj(str(tmp_path / "models" / "susanne.obj"), sphere())
    with pytest.raises(FileNotFoundError, match="ground.fbx"):
        thead.build_scene("config2")


def test_config2_builds_from_its_files(tmp_path):
    os.makedirs(tmp_path / "models")
    os.makedirs(tmp_path / "textures")
    cs.write_obj(str(tmp_path / "models" / "susanne.obj"), sphere())
    ground = tmesh.Mesh(np.array([[-20, 0, -20], [-20, 0, 20], [20, 0, 20], [20, 0, -20]],
                                 np.float32), None, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    cs.write_fbx(str(tmp_path / "models" / "ground.fbx"), ground)
    faces = np.random.default_rng(1).uniform(0, 2, (6, 4, 4, 3)).astype(np.float32)
    write_dds(str(tmp_path / "textures" / "CathedralRadiance.dds"), faces)
    sc, _ = thead.config2_scene(str(tmp_path))
    scene = sc.build("cpu")
    assert scene["num_tris"] == sphere().num_triangles + 2
    assert "textures" in scene and int(scene["env"]["kind"]) == 3
    assert [len(sc.lights[g]) for g in ("dir", "point", "area")] == [1, 0, 1]


def test_checkpoint_every_resume_is_bit_equal(tmp_path, monkeypatch):
    """--checkpoint-every 2 on 6 spp, the process dying in frame 5, then a
    --resume from the frame-4 checkpoint: bit-equal to the uninterrupted
    run."""
    path = str(tmp_path / "cornell.obj")
    mesh, materials = thead.cornell_box(glossy_tall_box=True)
    cs.write_obj(path, cs.first_use_order(tmesh.Mesh(
        mesh.positions, mesh.normals, mesh.indices, material_ids=mesh.material_ids,
        materials=materials)))
    args = ["--scene", path, "--size", f"{SIZE}x{SIZE}", "--spp", "6", "--device", "cpu"]
    full, resumed, ck = (str(tmp_path / n) for n in ("full.npy", "resumed.npy", "ck"))
    assert thead.main(args + ["-o", full]) == 0

    real_render = tprog.ProgressiveRaytracingPipeline.render

    def dies_in_frame_5(self):
        if self.accum_count == 5:
            raise RuntimeError("process death")
        return real_render(self)

    monkeypatch.setattr(tprog.ProgressiveRaytracingPipeline, "render", dies_in_frame_5)
    with pytest.raises(RuntimeError, match="process death"):
        thead.main(args + ["--save-state", ck, "--checkpoint-every", "2", "-o", resumed])
    monkeypatch.setattr(tprog.ProgressiveRaytracingPipeline, "render", real_render)
    assert int(np.load(ck + ".npz")["frames_done"]) == 4
    assert thead.main(args + ["--resume", ck, "-o", resumed]) == 0
    np.testing.assert_array_equal(np.load(resumed), np.load(full))
    with pytest.raises(SystemExit):
        thead.main(args + ["--checkpoint-every", "2", "-o", resumed])  # needs --save-state


def test_realtime_ignores_progressive_flags_as_jax(tmp_path, monkeypatch, capsys):
    flags = ["--accel", "two-level", "--animate-instances", "--ao-only", "--refraction"]
    args = ["--pipeline", "realtime", "--scene", "cornell-glossy", "--size", f"{SIZE}x{SIZE}"]
    with_flags, without = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    assert thead.main(args + flags + ["--device", "cpu", "-o", with_flags]) == 0
    assert ("realtime: ignoring --accel two-level, --animate-instances, --ao-only, "
            "--refraction") in capsys.readouterr().out
    assert thead.main(args + ["--device", "cpu", "-o", without]) == 0
    got = np.load(with_flags)
    np.testing.assert_array_equal(got, np.load(without))

    written = []
    monkeypatch.setattr(jhead, "write_png", lambda path, img: written.append(np.asarray(img)))
    assert jhead.main(args + flags + ["-o", str(tmp_path / "j.png")]) == 0
    want = written[0]
    diff = np.abs(np.clip(got, 0.0, 1.0) - want)
    assert (diff > 1e-3).any(axis=-1).mean() <= 0.01
    assert float(np.median(diff)) <= 1e-5
