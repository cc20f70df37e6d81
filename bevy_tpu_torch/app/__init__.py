from bevy_tpu_torch.app.app import App  # noqa: F401
from bevy_tpu_torch.app.plugin import Plugin  # noqa: F401
