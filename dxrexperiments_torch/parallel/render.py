"""Multi-GPU rendering (``dxrexperiments_tpu.parallel.render``): image rows
over a "tile" axis and each step's samples over an "spp" axis of a grid of
ranks, one process per device, over ``torch.distributed``.

  * tile parallelism: rank r renders rows [t * h, (t + 1) * h) of the
    image, t = r // n_spp, h = height / n_tile; the megakernels B1 and B5
    take the row offset and the full height (``py0``/``full_height``), the
    wavefront integrator ``row0``/``full_height``, so NDC and the TEA pixel
    seeds are the full image's and the row blocks put together are the
    single-process image;
  * sample parallelism: rank r renders samples [j * s, (j + 1) * s) of the
    step's S, j = r % n_spp, s = S / n_spp, and one all-reduce over the
    "spp" group forms the mean;
  * the scene is read-only and replicated (``replicate_scene``);
  * the denoiser's horizontal pass is row-local; its vertical pass runs on
    the row block padded with MAX_EXTENT (25) rows of each tile neighbour,
    zeros at the image's edges (out-of-bounds reads are 0, as in the
    single pass), or on the gathered full columns where a block is shorter
    than 25 rows.

Collectives: only ``broadcast`` and ``all_reduce``, the two that gloo takes
for CUDA tensors as NCCL does, so one code path runs on NCCL between cards,
on gloo on the CPU, and on gloo for ranks that share one card. The halo is
one all-reduce of a zeroed [n_tile, 2, 2, 25, W, 3] border buffer in which
each rank fills its own slot; the short-block path and ``gather_rows`` one
all-reduce of a zeroed [n_tile, h, ...] buffer in which each rank fills its
rows. A collective on an axis of one rank is skipped. A failed collective
raises: nothing here falls back to a single process.

Without an initialised process group a 1x1 mesh runs this code in one
process, as JAX's single-device mesh does (``--shard 1x1``).
"""

from __future__ import annotations

import dataclasses
import zlib

import torch
import torch.distributed as dist

from ..core.camera import stack_cameras  # noqa: F401  (the JAX module's export)
from ..core.device import setup_device
from ..models.base import select_route
from ..models.denoise import MAX_EXTENT, composite_tail
from ..ops import bilateral, fused_sample, fused_traverse
from ..scene.scene import scene_device
from ..trace.integrator import progressive_sample_sum, render_sample, resolve_impl


@dataclasses.dataclass
class RenderMesh:
    """A ("tile", "spp") grid of ranks: rank r at (r // n_spp, r % n_spp),
    as JAX reshapes its devices. ``tile_group`` holds the ranks of this
    rank's spp index (the "tile" axis), ``spp_group`` those of its tile
    index (the "spp" axis); both None without a process group."""

    n_tile: int
    n_spp: int
    rank: int
    device: torch.device
    distributed: bool
    tile_group: object = None
    spp_group: object = None

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "spp": self.n_spp}

    @property
    def tile(self) -> int:
        return self.rank // self.n_spp

    @property
    def spp(self) -> int:
        return self.rank % self.n_spp

    def sum_tile(self, x: torch.Tensor) -> torch.Tensor:
        """In-place sum of x over the "tile" axis."""
        if self.n_tile > 1:
            dist.all_reduce(x, group=self.tile_group)
        return x

    def sum_spp(self, x: torch.Tensor) -> torch.Tensor:
        """In-place sum of x over the "spp" axis."""
        if self.n_spp > 1:
            dist.all_reduce(x, group=self.spp_group)
        return x


def make_render_mesh(n_tile: int | None = None, n_spp: int | None = None,
                     device: str | torch.device = "cuda") -> RenderMesh:
    """The ("tile", "spp") mesh over the initialised process group's ranks
    (one rank without one). Defaults: every rank on "tile". Every rank
    calls ``new_group`` for every subgroup, in the same order.

    device: 'cuda' puts rank r on card r % device_count (ranks may share a
    card), a 'cuda:i' or 'cpu' name is taken as it is; no card for 'cuda'
    raises."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if n_tile is None and n_spp is None:
        n_tile, n_spp = world, 1
    elif n_tile is None:
        n_tile = world // n_spp
    elif n_spp is None:
        n_spp = world // n_tile
    if n_tile < 1 or n_spp < 1 or n_tile * n_spp != world:
        raise ValueError(f"mesh {n_tile}x{n_spp} does not cover the {world} ranks")
    if str(device) == "cuda":
        setup_device("cuda")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    mesh = RenderMesh(n_tile, n_spp, rank, setup_device(device), distributed)
    if distributed:
        for j in range(n_spp):  # the "tile" axis of spp index j
            group = dist.new_group([t * n_spp + j for t in range(n_tile)])
            if j == mesh.spp:
                mesh.tile_group = group
        for t in range(n_tile):  # the "spp" axis of tile index t
            group = dist.new_group([t * n_spp + j for j in range(n_spp)])
            if t == mesh.tile:
                mesh.spp_group = group
    return mesh


def _tensor_leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensor_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, f"{path}/{i}")


def replicate_scene(scene: dict, mesh: RenderMesh) -> dict:
    """Broadcast every tensor of the scene dict from rank 0, in place, so
    that every rank renders rank 0's scene; its derived arrays
    (``tri_records``, ``ft_test``, ``ft_attr``, ``blas_test``) are tensors of
    the dict and go with it. Each rank builds the scene first; one whose
    structure (keys, shapes, dtypes) differs from rank 0's raises on every
    rank. Without a process group the scene is returned as it is."""
    if not mesh.distributed:
        return scene
    leaves = list(_tensor_leaves(scene))
    sig = zlib.crc32(repr([(p, tuple(t.shape), str(t.dtype)) for p, t in leaves]).encode())
    root = torch.tensor([sig], dtype=torch.int64)
    dist.broadcast(root, 0)
    same = torch.tensor([int(int(root) == sig)], dtype=torch.int64)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if not int(same):
        raise ValueError("the scene's structure differs between ranks")
    for path, t in leaves:
        if t.numel() == 0:
            continue
        if not t.is_contiguous():
            raise ValueError(f"scene tensor {path} is not contiguous")
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, 0)
    return scene


def _row_block(height: int, mesh: RenderMesh) -> tuple[int, int]:
    if height % mesh.n_tile:
        raise ValueError(f"height {height} % tile axis {mesh.n_tile} != 0")
    h_local = height // mesh.n_tile
    return h_local, mesh.tile * h_local


def _spp_share(cameras: dict, mesh: RenderMesh) -> dict:
    s_count = int(cameras["eye"].shape[0])
    if s_count % mesh.n_spp:
        raise ValueError(f"samples {s_count} % spp axis {mesh.n_spp} != 0")
    s_local = s_count // mesh.n_spp
    return {k: v[mesh.spp * s_local:(mesh.spp + 1) * s_local] for k, v in cameras.items()}


def render_samples_sharded(scene: dict, options: dict, cameras: dict, width: int, height: int,
                           mesh: RenderMesh, mode: str = "progressive",
                           ao_only: bool = False) -> torch.Tensor:
    """The mean of S samples (CameraParams stacked on [S]) through the
    wavefront integrator: this rank's row block and its share of the
    samples, then one sum over "spp". Returns this rank's rows of the mean,
    [height / n_tile, W, 3]."""
    h_local, py0 = _row_block(height, mesh)
    impl = resolve_impl("auto", scene_device(scene))
    total = None
    mine = _spp_share(cameras, mesh)
    for s in range(int(mine["eye"].shape[0])):
        color = render_sample(scene, options, {k: v[s] for k, v in mine.items()}, width,
                              h_local, mode=mode, ao_only=ao_only, impl=impl, row0=py0,
                              full_height=height)["color"]
        total = color if total is None else total + color
    return mesh.sum_spp(total) / int(cameras["eye"].shape[0])


def progressive_step_sharded(scene: dict, options: dict, cameras: dict, accum: torch.Tensor,
                             width: int, height: int, mesh: RenderMesh) -> torch.Tensor:
    """One accumulation step of S samples into this rank's rows of the
    accumulator: accum' = (count * accum + S * mean) / (count + S)."""
    s_count = int(cameras["eye"].shape[0])
    mean = render_samples_sharded(scene, options, cameras, width, height, mesh)
    count = float(cameras["accum_count"][0])
    return (count * accum + s_count * mean) / (count + s_count)


def make_sharded_progressive_step(scene: dict, width: int, height: int, mesh: RenderMesh,
                                  samples_per_step: int = 1, ao_only: bool = False):
    """The sharded progressive step. Returns ``step(accum, options, cameras,
    lights, env, max_iterations)``: accum is this rank's rows [height /
    n_tile, W, 3], cameras the step's S = samples_per_step CameraParams
    stacked on [S] (every rank passes all S and renders its share). Per
    shard one launch of B1 or B5 for its rows and samples, else the
    wavefront integrator's samples, as ``models.progressive.
    make_progressive_step`` routes; one sum over "spp". accumCount advances
    by S; a step at max_iterations or beyond returns accum."""
    h_local, py0 = _row_block(height, mesh)
    s_count = int(samples_per_step)
    if s_count % mesh.n_spp:
        raise ValueError(f"samples_per_step {s_count} % spp axis {mesh.n_spp} != 0")
    env_kind = int(scene["env"]["kind"])
    route = select_route(scene, "progressive", ao_only)
    geo = {k: v for k, v in scene.items() if k not in ("lights", "env")}
    rows = {"py0": py0, "full_height": height}
    if route == "fused":
        sample_sum = fused_sample.fused_progressive_sum
    elif route == "fused_traverse":
        sample_sum = fused_traverse.fused_traverse_progressive_sum
    else:
        impl = resolve_impl("auto", scene_device(scene))

        def sample_sum(full, options, cams, w, h, ek, py0, full_height):
            return progressive_sample_sum(full, options, cams, w, h, ek,
                                          fused_sample.JITTER_SCALE, impl=impl,
                                          ao_only=ao_only, row0=py0, full_height=full_height)

    def step(accum, options, cameras, lights, env, max_iterations):
        if int(cameras["eye"].shape[0]) != s_count:
            raise ValueError(f"expected {s_count} cameras, got {int(cameras['eye'].shape[0])}")
        count = float(cameras["accum_count"][0])
        if count >= float(max_iterations):
            return accum
        full = dict(geo, lights=lights, env=env)
        local_sum = sample_sum(full, options, _spp_share(cameras, mesh), width, h_local,
                               env_kind, **rows)
        mean = mesh.sum_spp(local_sum) / s_count
        return (count * accum + s_count * mean) / (count + s_count)

    return step


def _halo_rows(xs: list, r: int, mesh: RenderMesh) -> list:
    """Each row block of ``xs`` (same shape [h, ...]) padded with r rows of
    its tile neighbours above and below, in one all-reduce: a zeroed
    [n_tile, 2, len(xs), r, ...] buffer in which this rank fills slot 0
    with its first r rows (its upper neighbour's lower halo) and slot 1
    with its last r. Edge blocks get zero rows: out-of-bounds reads are 0,
    as in the single pass."""
    x0 = xs[0]
    buf = torch.zeros((mesh.n_tile, 2, len(xs), r, *x0.shape[1:]), dtype=x0.dtype,
                      device=x0.device)
    t = mesh.tile
    for i, x in enumerate(xs):
        buf[t, 0, i] = x[:r]
        buf[t, 1, i] = x[-r:]
    mesh.sum_tile(buf)
    zero = torch.zeros((r, *x0.shape[1:]), dtype=x0.dtype, device=x0.device)
    return [torch.cat([buf[t - 1, 1, i] if t > 0 else zero, x,
                       buf[t + 1, 0, i] if t + 1 < mesh.n_tile else zero])
            for i, x in enumerate(xs)]


def gather_rows(xs, mesh: RenderMesh):
    """The full-height tensors of row blocks, on every rank of this rank's
    "tile" axis (rank 0 among them): one all-reduce of a zeroed
    [n_tile, h, sum of the row sizes] buffer in which each rank fills its
    own block. xs: a tensor or a list of tensors of h rows each; the
    results are contiguous."""
    single = isinstance(xs, torch.Tensor)
    xs = [xs] if single else list(xs)
    if mesh.n_tile > 1:
        h = xs[0].shape[0]
        widths = [x[0].numel() for x in xs]
        buf = torch.zeros((mesh.n_tile, h, sum(widths)), dtype=xs[0].dtype, device=xs[0].device)
        buf[mesh.tile] = torch.cat([x.reshape(h, -1) for x in xs], dim=1)
        mesh.sum_tile(buf)
        parts = buf.reshape(mesh.n_tile * h, -1).split(widths, dim=1)
        # contiguous: a kernel takes them (the short-block vertical pass)
        xs = [p.reshape(mesh.n_tile * h, *x.shape[1:]).contiguous() for p, x in zip(parts, xs)]
    return xs[0] if single else xs


def _denoise_local(direct: torch.Tensor, indirect: torch.Tensor, params: dict,
                   mesh: RenderMesh, h_local: int) -> torch.Tensor:
    """``models.denoise.denoise_composite`` on this rank's row block: the
    horizontal pass (B2 on CUDA tensors) on the block, the vertical pass on
    the block padded with MAX_EXTENT rows of each neighour (``_halo_rows``),
    or on the gathered full columns when the block is shorter than that,
    then the composite tail. debug_visualize 2 skips both passes, as the
    single-process denoiser does."""
    radius = float(params["max_kernel_size"])
    if int(params["debug_visualize"]) == 2:
        return composite_tail(direct, indirect, params)
    pass0 = bilateral.bilateral_pass(indirect, direct, radius, 1)
    if mesh.n_tile == 1:
        pass1 = bilateral.bilateral_pass(pass0, direct, radius, 0)
    elif h_local >= MAX_EXTENT:
        r = MAX_EXTENT
        p0, d = _halo_rows([pass0, direct], r, mesh)
        pass1 = bilateral.bilateral_pass(p0, d, radius, 0)[r:-r]
    else:  # the block is shorter than the filter's support: full columns
        p0, d = gather_rows([pass0, direct], mesh)
        t = mesh.tile
        pass1 = bilateral.bilateral_pass(p0, d, radius, 0)[t * h_local:(t + 1) * h_local]
    return composite_tail(direct, pass1, params)


def make_sharded_realtime_step(scene: dict, width: int, height: int, mesh: RenderMesh,
                               denoise: bool = True):
    """The sharded realtime frame on a tile-only mesh (n_spp 1): each rank's
    row block through B1 or B5 (one launch) or the wavefront integrator, as
    ``select_route`` routes, then the row-sharded denoiser. Returns
    ``step(options, camera, lights, env, denoise_params) -> dict`` of this
    rank's rows of the AOVs (``direct``, ``indirect_specular``, ``albedo``,
    ``color`` [h, W, 3], ``roughness`` [h, W]) and, with denoise,
    ``display``."""
    if mesh.n_spp != 1:
        raise ValueError("realtime sharding uses a tile-only mesh (n_spp=1)")
    h_local, py0 = _row_block(height, mesh)
    env_kind = int(scene["env"]["kind"])
    route = select_route(scene, "realtime")
    resolved = resolve_impl("auto", scene_device(scene))
    geo = {k: v for k, v in scene.items() if k not in ("lights", "env")}

    def step(options, camera, lights, env, denoise_params):
        full = dict(geo, lights=lights, env=env)
        if route == "fused":
            out = fused_sample.fused_realtime_outputs(full, options, camera, width, h_local,
                                                      env_kind, py0=py0, full_height=height)
        elif route == "fused_traverse":
            out = fused_traverse.fused_traverse_realtime_outputs(
                full, options, camera, width, h_local, env_kind, py0=py0, full_height=height)
        else:
            out = render_sample(full, options, camera, width, h_local, mode="realtime",
                                jitter_scale=fused_sample.REALTIME_JITTER_SCALE, impl=resolved,
                                env_kind=env_kind, row0=py0, full_height=height)
        if denoise:
            out = dict(out, display=_denoise_local(out["direct"], out["indirect_specular"],
                                                   denoise_params, mesh, h_local))
        return out

    return step
