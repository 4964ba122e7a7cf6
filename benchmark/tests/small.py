"""Small sizes of the cells for the CPU tests: the same code and
configuration keys, fewer bath levels and frequencies."""

import numpy as np

LOOP = {"c": {"nbath": 4, "lmats": 400, "lreal": 400},
        "t": {"iters_per_episode": 2, "check_episodes": 1}}
GS = {"c": {"nbath": 7, "sector": [4, 4],
            "bath_e": list(np.linspace(-1.0, 1.0, 7)),
            "bath_v": [0.42, 0.55, 0.61, 0.33, 0.47, 0.58, 0.66]},
      "t": {}}
SIZES = {"hm_bethe_nb6.loop": LOOP, "impurity_nb13.gs": GS,
         "impurity_nb13.gs_ozaki5x7": GS}
SEED = 2 ** 31 + 977


def run(workload, trace=False, seed=SEED, seconds=0.2, variant=None):
    """One CPU run of a cell at its small size; the result line."""
    from benchmark import harness
    ov = SIZES[workload]
    return harness.run_cell(harness.load_spec(held=True), workload, seed,
                            seconds, trace, "cpu", config_overrides=ov["c"],
                            traffic_overrides=ov["t"], variant=variant)
