"""B6a's bound: the work that any walk of a two-level scene must do for a
progressive dispatch's rays, whatever trees it walks. It counts neither
B6a's TLAS and BLAS nodes nor its lanes.

Per live ray, as the reference counts them (``harness.b1_rays``: the
closest and any-hit rays of a dispatch with a non-empty window):

    operations  OPS_ENTRY + roofline.OPS_PAIR = 36 + 50 = 86: one instance
                entry (the ray taken into object space: the origin by a 3x3
                rotation and a translation, 9 multiply-adds = 18; the
                direction by the rotation, 3 products and 6 multiply-adds =
                15; the direction's reciprocal for the slab tests, 3) and
                one pair test;
    bytes       RAY_IN + RAY_OUT = 32 + 1 = 33: the ray read once (origin,
                direction, t_min, t_max, float32) and the least a ray
                writes (an any-hit ray's occlusion flag; the census adds
                closest and any-hit rays together, so each counts at that
                byte, though a closest ray writes 20: t, triangle, u, v,
                instance).

Per launch, read once: every instance's row (INST_WORDS float32) and
every BLAS triangle's record (REC_WORDS float32, the record of
``roofline.TRI_WORDS``). A dispatch of S samples makes LAUNCHES_PER_SAMPLE
launches a sample: the primary closest trace, the depth-0 shadow rays, the
bounce rays' closest trace and the depth-1 shadow rays. Bound =
``roofline.bound`` (float32 peak, HBM rate).
"""

from __future__ import annotations

from portbench import roofline

OPS_ENTRY = 36
RAY_IN = 32
RAY_OUT = 1
INST_WORDS = 16
REC_WORDS = 20
LAUNCHES_PER_SAMPLE = 4


def blas_tris(spec: dict) -> int:
    """Triangles of the BLASes: each mesh that an instance uses, once."""
    return sum(len(spec["meshes"][m]["indices"]) for m in {i["mesh"] for i in spec["instances"]})


def b6a_bound(rays: float, instances: int, tris: int, launches: int) -> tuple[float, str]:
    """(bound_ms, bound_by) for ``rays`` live rays over ``launches``
    launches of a scene of ``instances`` instances and ``tris`` BLAS
    triangles."""
    ops = rays * (OPS_ENTRY + roofline.OPS_PAIR)
    nbytes = rays * (RAY_IN + RAY_OUT) + launches * (instances * INST_WORDS + tris * REC_WORDS) * 4
    return roofline.bound(ops, nbytes)
