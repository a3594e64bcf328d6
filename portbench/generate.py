"""What every input generator of the benchmark shares: ``--seed`` as a
64-bit seed, and one ``torch.Generator`` on the run's device for each
named stream of it.

The inputs themselves are drawn by files found by name
(``registry``): a configuration's graph by its shape,
``shapes/<shape>.py``, and a traffic mix's masks by its subset kind,
``subsets/<subsets>.py``. Streams in use: 0, the bubble chain's arena;
1 and 2, the uniform kind's window and warm-up pools (the harness's own
sample of answers draws from numpy's stream 3). A new generator takes
a stream number no other draw of its run takes.
"""

from __future__ import annotations

import numpy as np
import torch


def seed64(seed: int) -> int:
    """``--seed`` as the unsigned 64-bit seed both generators take."""
    return int(seed) % (1 << 64)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of a seed: the
    arena, the masks and the warm-up masks each draw from their own."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(np.random.SeedSequence([seed64(seed), stream])
                           .generate_state(1, np.uint64)[0]))
    return gen
