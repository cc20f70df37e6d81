"""Plugin protocol (port of bevy_tpu/app/plugin.py; ref: bevy_app
plugin.rs:57 — build/finish phases)."""


class Plugin:
    def build(self, app):
        raise NotImplementedError

    def finish(self, app):
        pass

    @property
    def name(self):
        return type(self).__name__

