"""Stepping debugger (port of bevy_tpu/stepping.py; ref: bevy_ecs Stepping,
`bevy_ecs/src/schedule/stepping.rs`: pause marked schedules and run their
systems one at a time).

Enabled stepping pulls the marked schedules out of the frame (they do
nothing while paused); `step()` runs their next system against the
world's state, so the state between steps is real and readable.
"""

from __future__ import annotations

from bevy_tpu_torch.ecs.schedule import run_entry, run_host_entry


class Stepping:
    """ref: the Stepping resource. Usage::

        st = Stepping(app).add_schedule(Update)
        st.enable()
        app.update()        # Update's systems are skipped this frame
        name = st.step()    # run exactly one system, returns its name
        st.continue_()      # run the rest of the schedule's systems
        st.disable()        # Update runs in the frame again
    """

    def __init__(self, app):
        self.app = app
        self.labels = []
        self.enabled = False
        self._cursor = 0
        app._stepping = self

    def add_schedule(self, label):
        """Mark a schedule for stepping (ref: Stepping::add_schedule)."""
        if label not in self.labels:
            self.labels.append(label)
        return self

    def enable(self):
        self.enabled = True
        self._cursor = 0
        self.app.world.structure_version += 1
        return self

    def disable(self):
        self.enabled = False
        self.app.world.structure_version += 1
        return self

    def _entries(self):
        out = []
        for label in self.labels:
            sched = self.app.schedules.get(label)
            if sched is not None:
                sched.init_systems(self.app.world)
                out += sched.items()
        return out

    def step(self):
        """Run the next stepped system; returns its name (None when the
        cursor wrapped: the pass over the stepped systems completed)."""
        if not self.enabled:
            raise RuntimeError("Stepping.step() requires enable() first")
        entries = self._entries()
        if not entries:
            return None
        if self._cursor >= len(entries):
            self._cursor = 0
            return None
        entry = entries[self._cursor]
        self._cursor += 1
        self._run(entry)
        return entry.system.name

    def continue_(self):
        """Run the remaining stepped systems and wrap the cursor (ref:
        Stepping::continue_frame); returns the names run."""
        if not self.enabled:
            raise RuntimeError("Stepping.continue_() requires enable() first")
        entries = self._entries()
        names = []
        while self._cursor < len(entries):
            entry = entries[self._cursor]
            self._cursor += 1
            self._run(entry)
            names.append(entry.system.name)
        self._cursor = 0
        return names

    def _run(self, entry):
        world = self.app.world
        if entry.system.host:
            run_host_entry(entry, world)
        else:
            world.state = run_entry(entry, world.state, world)
