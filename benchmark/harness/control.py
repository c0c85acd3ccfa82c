"""Readings of a cell's compared numbers, over several seeds, for the
program as the configuration states it, for its control, and for the
program with a fault planted (`harness/faults.py`). The limits in
`workloads/<cell>.json` are set from these readings.

    python3 benchmark/harness/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control] [--fault <f>]

Frame cells: one process, the system built once a side, each seed its own
short window at the cell's own load, every frame the window served judged
as a run judges its sample; the control is the configuration's
`control.precision`, the program's own lower-precision path. Training
cells: each seed builds the trainer and takes the two judged stretches a
run takes; the control is the reference with float8 products in the
program's place. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_BENCH, os.path.dirname(_BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import faults, frames, manifest, steps  # noqa: E402


def readings(workload: str, seeds, seconds: float, control: bool, device="cuda", fault=None) -> list:
    """[{"seed", "precision", "numbers", ...}] a seed; with `fault` (a name
    in `harness/faults.py`), the program's readings with that fault planted."""
    man = manifest.manifest()
    entry = manifest.workload_entry(man, workload)
    config = manifest.load_config(man, entry["config"])
    mix = manifest.load_traffic(entry["traffic"])
    cell = manifest.load_cell(workload)
    gen = manifest.generator(mix["kind"])
    with faults.PATCHES[fault]() if fault in faults.PATCHES else contextlib.nullcontext():
        if gen.DRIVER == "steps":
            return _step_readings(config, mix, cell, gen, seeds, control, device)
        return _frame_readings(config, mix, cell, gen, seeds, seconds, control, device,
                               serve=faults.stale_answer(gen.serve) if fault == "stale_answer" else None)


def _frame_readings(config, mix, cell, gen, seeds, seconds, control: bool, device, serve=None) -> list:
    precision = config["control"]["precision"] if control else config["serve"]["precision"]
    fc = frames.FrameCell(config, mix, cell, gen, device, precision=precision, serve=serve)
    nets = frames.reference_nets(config, fc.device)
    fc.warm(int(seeds[0]))
    out = []
    for seed in seeds:
        win = fc.window(int(seed), seconds)
        verdict = frames.judge(win, config, mix, cell, gen, fc.device, nets=nets)
        out.append(dict(seed=int(seed), precision=precision, frames=len(win.requests), errors=len(win.errors),
                        numbers=verdict["numbers"], frame_means=verdict["frame_means"],
                        frame_biases=verdict["frame_biases"]))
    return out


def _step_readings(config, mix, cell, gen, seeds, control: bool, device) -> list:
    """The program's two judged stretches against the reference a seed; or,
    for the control, the reference's own steps with float8 products in the
    program's place, taken the same way: the start from the benchmark's
    weights, then a stretch from where it left off."""
    import torch

    from reference import train as ref_train

    out = []
    for seed in seeds:
        if control:
            dev = torch.device(device)
            poses = gen.views(mix)
            system = dict(poses=poses, rgb=gen.colours(mix, len(poses), int(seed), dev))
            init = ref_train.init_weights(config["nets"], int(seed), dev)
            rays, rgbs = gen.reference_inputs(system, mix, dev)
            n = steps.stretch_steps(gen.steps_per_call(mix))
            spec = steps.reference_spec(config, mix)
            a = ref_train.run_steps(init, config["nets"], rays, rgbs, int(seed), n, spec, matmul=ref_train.fp8_matmul)
            b = ref_train.run_steps(a.params, config["nets"], rays, rgbs, int(seed), n, spec,
                                    matmul=ref_train.fp8_matmul, start_step=n, moments=(a.m, a.v))
            stretches = [steps.Stretch(0, None, None, a.losses, a.params, a.m),
                         steps.Stretch(n, a.params, (a.m, a.v), b.losses, b.params, b.m)]
        else:
            sc = steps.StepCell(config, mix, cell, gen, device, int(seed))
            stretches = [sc.stretch(from_init=True), sc.stretch(from_init=False)]
            init = sc.system["init"]
            rays, rgbs = gen.reference_inputs(sc.system, mix, sc.device)
            sc.free()
        numbers, per = steps.judge(stretches, init, rays, rgbs, config, mix, int(seed))
        out.append(dict(seed=int(seed), precision="float8 reference" if control else "program", numbers=numbers,
                        per_stretch=per, losses=[st.losses for st in stretches]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true", help="the configuration's control precision")
    p.add_argument("--fault", choices=(*faults.PATCHES, "stale_answer"), help="a fault planted in the program")
    args = p.parse_args(argv)
    for r in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.control,
                      fault=args.fault):
        print(json.dumps(dict(workload=args.workload, fault=args.fault, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
