"""JSON memory serialization for the fixed-dimension accelerator.

The port's own copy of pollen_tpu/accel/datagen.py, byte-compatible
with the reference's data layout (reference:
pollen_data_gen/pollen_data_gen/depth.py and
pollen_py/pollen/depth/parse_data.py): per-node ``path_ids{i}``
memories (1-based node keys, crossing path ids padded with 0),
per-node ``paths_to_consider{i}`` bitvectors, and zeroed
``depth_output`` / ``uniq_output`` answer memories, each tagged with a
bitnum format of the right width.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..flatgfa import GraphArrays


def _fmt(width: int) -> Dict:
    return {"is_signed": False, "numeric_type": "bitnum", "width": width}


def accel_dims(g: GraphArrays) -> Tuple[int, int, int]:
    """(max_nodes, max_steps, max_paths): tight dimensions for a graph."""
    counts = np.bincount(g.step_segs, minlength=g.num_segments)
    max_steps = int(counts.max()) if counts.size else 0
    return g.num_segments, max_steps, g.num_paths


def depth_json(
    g: GraphArrays,
    max_n: Optional[int] = None,
    max_e: Optional[int] = None,
    max_p: Optional[int] = None,
    subset_paths: Optional[List[str]] = None,
) -> str:
    """Serialize a graph into the accelerator's JSON memories."""
    n_tight, e_tight, p_tight = accel_dims(g)
    max_n = max_n or n_tight
    max_e = max_e or e_tight
    max_p = max_p or p_tight

    # Crossing path ids per node (1-based path ids, node-id order).
    out: Dict[str, Dict] = {}
    out["depth_output"] = {
        "data": [0] * max_n,
        "format": _fmt(max_e.bit_length()),
    }

    id_fmt = _fmt(max_p.bit_length())
    segs = g.step_segs
    path_ids = g.step_path_ids() + 1
    for i in range(g.num_segments):
        data = path_ids[segs == i].tolist()
        data += [0] * (max_e - len(data))
        out[f"path_ids{i + 1}"] = {"data": data, "format": id_fmt}
    for i in range(g.num_segments + 1, max_n + 1):
        out[f"path_ids{i}"] = {"data": [0] * max_e, "format": id_fmt}

    # Which paths to consider (bitvector indexed by 1-based path id).
    if subset_paths:
        by_name = {
            g.path_name_bytes(i).decode(): i + 1 for i in range(g.num_paths)
        }
        consider = [0] * (max_p + 1)
        for name in subset_paths:
            consider[by_name[name]] = 1
    else:
        consider = [0] + [1] * max_p
    for i in range(1, max_n + 1):
        out[f"paths_to_consider{i}"] = {"data": consider, "format": _fmt(1)}

    out["uniq_output"] = {
        "data": [0] * max_n,
        "format": _fmt(max_p.bit_length()),
    }
    return json.dumps(out, indent=2, sort_keys=True)


def parse_depth_json(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load accelerator memories back into (path_ids[N, E], consider[P+1])."""
    data = json.loads(text)
    nodes = sorted(
        int(k[len("path_ids") :])
        for k in data
        if k.startswith("path_ids")
    )
    ids = np.array(
        [data[f"path_ids{i}"]["data"] for i in nodes], dtype=np.int32
    )
    consider = np.array(
        data[f"paths_to_consider{nodes[0]}"]["data"], dtype=np.int32
    )
    return ids, consider


def output_json(depth: np.ndarray, uniq: np.ndarray) -> str:
    """Render results the way the simulated accelerator does."""
    return json.dumps(
        {
            "depth_output": depth.tolist(),
            "uniq_output": uniq.tolist(),
        },
        indent=2,
        sort_keys=True,
    )


def depth_table_from_outputs(depth: np.ndarray, uniq: np.ndarray) -> str:
    """odgi-style TSV from accelerator outputs (reference:
    parse_data.py from_calyx)."""
    lines = ["#node.id\tdepth\tdepth.uniq"]
    for i, (d, u) in enumerate(zip(depth, uniq), start=1):
        lines.append(f"{i}\t{int(d)}\t{int(u)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Generic graph JSON (reference: pollen_data_gen simple.py)
# ---------------------------------------------------------------------------


def graph_json(g: GraphArrays) -> str:
    """A generic, round-trippable JSON rendering of the whole graph."""
    from ..emit import link_lines, path_lines

    obj = {
        "headers": [g.header.tobytes().decode()] if g.header.size else [],
        "segments": {
            str(g.seg_name[i]): g.seg_sequence(i).decode()
            for i in range(g.num_segments)
        },
        "paths": {
            g.path_name_bytes(p).decode(): ln.split("\t")[2]
            for p, ln in zip(range(g.num_paths), path_lines(g))
        },
        "links": [ln[2:].replace("\t", " ") for ln in link_lines(g)],
    }
    return json.dumps(obj, indent=2, sort_keys=True)


def graph_from_json(text: str) -> GraphArrays:
    """Rebuild a graph from :func:`graph_json` output (round trip)."""
    from ..flatgfa import parse_gfa

    obj = json.loads(text)
    lines = [f"H\t{h}" for h in obj["headers"]]
    lines += [f"S\t{k}\t{v}" for k, v in obj["segments"].items()]
    lines += [f"P\t{k}\t{v}\t*" for k, v in obj["paths"].items()]
    lines += ["L\t" + ln.replace(" ", "\t") for ln in obj["links"]]
    return parse_gfa(("\n".join(lines) + "\n").encode())
