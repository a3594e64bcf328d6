"""route_replay_hit.single: the share of the single query's device
parts that replayed a captured CUDA graph (counter
``depth.route_replays`` over ``depth.route_parts``), %."""

from portbench import replay


def read(run):
    return replay.hit_share(run)
