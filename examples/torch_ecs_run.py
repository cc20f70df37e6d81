"""The command line of the ECS twins (examples/torch_<name>.py for the
examples of examples/ecs and examples/state): each twin module has
`build_app(device=...)`, `DT` (its frame's dt) and `script(app, k)`, the
host actions before frame k (k = 0, 1, ...; nothing past its last step).

    python examples/torch_states.py                 # 5 frames on the card
    python examples/torch_states.py --frames 60 --profile 10

prints the twin's resources after the frames, ms/frame by CUDA events
over the frames after the fifth, and with `--profile N` the kernel
launches, busy share and Memcpy DtoH records of N more frames.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def spec_named(app, bare):
    """The world's component spec whose bare storage name is `bare`."""
    from bevy_tpu_torch.ecs.component import bare_name
    return next(s for n, s in app.world.specs.items() if bare_name(n) == bare)


def drive(mod, app, frames, start=0):
    """Frames start .. frames-1 of the twin's script, each after its host
    actions; returns the app."""
    for k in range(start, frames):
        mod.script(app, k)
        app.update(dt=mod.DT)
    return app


def update_step(mod, app):
    """A `step(state) -> state` of one scripted frame past the script's
    end (what the profiler helpers time)."""
    def step(state):
        app.world.state = state
        app.update(dt=mod.DT)
        return app.world.state
    return step


def dtoh_records(prof):
    return sum(1 for e in prof.events() if "Memcpy DtoH" in e.name)


def run_twin(mod, argv=None):
    ap = argparse.ArgumentParser(description=mod.__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    app = mod.build_app(device=args.device)
    drive(mod, app, min(args.frames, 5))
    ms = None
    if args.frames > 5 and app.device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        drive(mod, app, args.frames, start=5)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (args.frames - 5)
    elif args.frames > 5:
        drive(mod, app, args.frames, start=5)
    for name, store in app.world.state["res"].items():
        if name in ("frame_input", "keyboard", "mouse", "touches",
                    "gamepad"):
            continue
        vals = {k: v.cpu().numpy().tolist() for k, v in store.items()
                if isinstance(v, torch.Tensor) and v.numel() <= 8}
        print(f"{name}: {vals}")
    print(f"tick {int(app.world.state['tick'])}, frame {app.frame}"
          + (f", {ms:.3f} ms/frame" if ms is not None else ""))
    if args.profile and app.device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile as torch_profile
        from torch_many_cubes import profile
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            update_step(mod, app)(app.world.state)
            torch.cuda.synchronize()
        print(f"one frame: {dtoh_records(prof)} Memcpy DtoH records")
        profile(update_step(mod, app), app.world.state, args.profile)
    return app
