"""Rank bodies of the port's multi-rank tests (test_torch_parallel.py,
test_torch_loader.py). Each runs in every rank of a job that
``pollen_tpu_torch.parallel.launch.run`` spawns, and returns that
rank's results as numpy arrays; the tests gather them and hold them
against the reference. A spawned rank imports this module, which
imports only numpy, torch and the port (never JAX nor the reference:
each rank also reports what it loaded of them).
"""

import dataclasses

import numpy as np
import torch


def host(x):
    return x.detach().cpu().numpy()


def layout(sg) -> dict:
    """A ShardedGraph's fields as numpy arrays and ints."""
    return {
        f.name: host(v) if isinstance(v, torch.Tensor) else v
        for f in dataclasses.fields(sg)
        for v in (getattr(sg, f.name),)
    }


def build(case, device):
    """The case's graph on this rank, with its planner constants set
    for the build only."""
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.kernels import ellscan

    saved = {k: getattr(ellscan, k) for k in case.get("ellscan", {})}
    try:
        for k, v in case.get("ellscan", {}).items():
            setattr(ellscan, k, v)
        return build_graph(case["arena"], device, **case.get("build", {}))
    finally:
        for k, v in saved.items():
            setattr(ellscan, k, v)


def run_case(case, mesh, device) -> dict:
    """Every sharded query a case asks for (``case["masks"]``: query
    name -> masks), on this rank's piece; each answer as numpy."""
    from pollen_tpu_torch.parallel import sharded as sh

    dg = build(case, device)
    masks = case["masks"]
    out = {}

    def t(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)

    scan_forms = {
        "seg": sh.sharded_seg_depth_fn,
        "scatter": sh.sharded_seg_depth_scatter_fn,
        "fused": sh.sharded_seg_depth_fused_fn,
    }
    if scan_forms.keys() & masks.keys():
        sg = sh.shard_device_graph(dg, mesh, block=case.get("block", 1))
        out["layout"] = layout(sg)
        for name, fn in scan_forms.items():
            query = fn(mesh)
            out[name] = [
                tuple(host(x) for x in query(sg, t(m)))
                for m in masks.get(name, [])
            ]
    if "degree" in masks:
        out["degree"] = host(
            sh.sharded_degree_fn(mesh)(*sh.shard_degree_inputs(dg, mesh))
        )
    if "cross" in masks:
        sc = sh.shard_cross_inputs(dg, mesh)
        query = sh.sharded_cross_depth_fn(mesh, nibble=sc.nibble)
        out["cross_width"] = sc.col_width
        out["cross"] = []
        for m in masks["cross"]:
            mp = torch.zeros(sc.num_paths_padded, dtype=torch.int32, device=device)
            mp[: m.shape[0]] = t(m)
            out["cross"].append(
                tuple(host(x) for x in query(sc.cross, sc.res, sc.res_seg, mp))
            )
    for name, fn in (("ell", sh.sharded_ell_depth_fn),
                     ("ell_batch", sh.sharded_ell_depth_batch_fn)):
        if name not in masks:
            continue
        se = sh.shard_ell_inputs(dg, mesh)
        query = fn(mesh, has_heavy=se.heavy is not None,
                   has_mid=se.ell2 is not None, has_mid2=se.ell3 is not None)
        out[name + "_has"] = (se.ell2 is not None, se.ell3 is not None,
                              se.heavy is not None)
        out[name] = [
            [host(p) for p in query(*sh.ell_args(se, t(m)))]
            for m in masks[name]
        ]
    return out


def parallel_cases(rank, world, device, cases) -> dict:
    """test_torch_parallel.py's job: every case on this rank."""
    from pollen_tpu_torch.parallel import dryrun, sharded

    mesh = sharded.make_mesh()
    out = {
        "mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names)),
        "index": sharded.mesh_index(mesh),
        "cases": {key: run_case(case, mesh, device) for key, case in cases.items()},
    }
    out["foreign_modules"] = dryrun.foreign_modules()
    return out


def exchange_ingest(rank, world, device, paths) -> dict:
    """test_torch_loader.py's job: each rank parses its own byte range of
    every file, the ranks exchange name tables and pools, and each
    assembles the arena (returned field by field), then the sharded
    ingest and one all-paths query on it."""
    from pollen_tpu_torch.parallel import distributed, dryrun, sharded

    mesh = sharded.make_mesh()
    out = {}
    for path in paths:
        arena = distributed.ingest_arena(path)
        sg = distributed.ingest(path, mesh, device=device)
        d, u = sharded.sharded_seg_depth_fn(mesh)(
            sg, sharded.full_mask(sg.num_paths, device)
        )
        out[path] = {
            "arena": {f.name: getattr(arena, f.name) for f in dataclasses.fields(arena)},
            "depth": host(d),
            "uniq": host(u),
        }
    out["foreign_modules"] = dryrun.foreign_modules()
    return out


def scale_sharded(rank, world, device, n_steps, n_segs, n_paths) -> dict:
    """test_torch_scale.py's job: every rank synthesises the same seeded
    graph, ingests it, and answers the all-paths query sharded over the
    job, by the plain step-chunk form and by the fused scan form."""
    from pollen_tpu_torch.device import build_graph
    from pollen_tpu_torch.parallel import dryrun, sharded
    from pollen_tpu_torch.synth import synth_graph

    mesh = sharded.make_mesh()
    dg = build_graph(synth_graph(n_steps, n_segs, n_paths), device,
                     cross_matrix="never")
    sg = sharded.shard_device_graph(dg, mesh)
    mask = sharded.full_mask(n_paths, device)
    out = {}
    for name, fn in (("seg", sharded.sharded_seg_depth_fn),
                     ("fused", sharded.sharded_seg_depth_fused_fn)):
        out[name] = tuple(host(x) for x in fn(mesh)(sg, mask))
    out["foreign_modules"] = dryrun.foreign_modules()
    return out
