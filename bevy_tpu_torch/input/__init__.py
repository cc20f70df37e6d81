"""Input (port of bevy_tpu/input/__init__.py; ref: bevy_input —
ButtonInput<T> pressed / just_pressed / just_released `src/button_input.rs`,
keyboard, mouse, gamepad and touch models; bevy_winit's converters are the
App's frame-input channels).

Headless model: the host sets input state between frames
(`keyboard.press/release`, `mouse.move_to`, `gamepad.set_axis`); the values
enter each frame as one host-to-device copy (App.register_frame_input), and
First-schedule systems derive just_pressed / just_released on the device —
systems read the `keyboard` / `mouse` / `gamepad` / `touches` resources
as the reference's `Res<ButtonInput<KeyCode>>`.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import First
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Res, ResMut
from bevy_tpu_torch.ecs.system import system

NUM_KEYS = 256
NUM_MOUSE_BUTTONS = 8
NUM_GAMEPAD_AXES = 8
NUM_GAMEPAD_BUTTONS = 16
MAX_TOUCHES = 8


class KeyCode:
    """Stable key indices (subset of ref: bevy_input KeyCode)."""
    _names = [
        "KeyA", "KeyB", "KeyC", "KeyD", "KeyE", "KeyF", "KeyG", "KeyH",
        "KeyI", "KeyJ", "KeyK", "KeyL", "KeyM", "KeyN", "KeyO", "KeyP",
        "KeyQ", "KeyR", "KeyS", "KeyT", "KeyU", "KeyV", "KeyW", "KeyX",
        "KeyY", "KeyZ",
        "Digit0", "Digit1", "Digit2", "Digit3", "Digit4", "Digit5",
        "Digit6", "Digit7", "Digit8", "Digit9",
        "ArrowLeft", "ArrowRight", "ArrowUp", "ArrowDown",
        "Space", "Enter", "Escape", "Tab", "Backspace", "Delete",
        "ShiftLeft", "ShiftRight", "ControlLeft", "ControlRight",
        "AltLeft", "AltRight", "Home", "End", "PageUp", "PageDown",
    ]


for _i, _n in enumerate(KeyCode._names):
    setattr(KeyCode, _n, _i)


class MouseButton:
    Left = 0
    Right = 1
    Middle = 2


class InputState:
    """Host-side live input device state (what winit events would mutate)."""

    def __init__(self):
        self.keys = np.zeros(NUM_KEYS, bool)
        self.mouse_buttons = np.zeros(NUM_MOUSE_BUTTONS, bool)
        self.mouse_pos = np.zeros(2, np.float32)
        self.mouse_delta = np.zeros(2, np.float32)
        self.scroll = np.zeros(2, np.float32)
        self.gamepad_axes = np.zeros(NUM_GAMEPAD_AXES, np.float32)
        self.gamepad_buttons = np.zeros(NUM_GAMEPAD_BUTTONS, bool)
        self.touches = np.zeros((MAX_TOUCHES, 3), np.float32)  # active,x,y
        self.pending_rumble = []   # drained by a host gamepad driver

    # -- the API a host driver / test calls between frames ---------------
    def press(self, key):
        self.keys[key] = True

    def release(self, key):
        self.keys[key] = False

    def press_mouse(self, button):
        self.mouse_buttons[button] = True

    def release_mouse(self, button):
        self.mouse_buttons[button] = False

    def move_to(self, x, y):
        self.mouse_delta = np.asarray([x, y], np.float32) - self.mouse_pos
        self.mouse_pos = np.asarray([x, y], np.float32)

    def set_axis(self, axis, value):
        self.gamepad_axes[axis] = value

    def rumble(self, strength=1.0, duration=0.25, gamepad=0):
        """Queue a force-feedback pulse (ref: GamepadRumbleRequest); a
        gamepad driver drains `pending_rumble`."""
        self.pending_rumble.append(
            {"gamepad": int(gamepad), "strength": float(strength),
             "duration": float(duration)})

    def wheel(self, dx=0.0, dy=0.0):
        """Set this frame's scroll-wheel delta (sticky until changed)."""
        self.scroll = np.asarray([dx, dy], np.float32)

    def set_gamepad_button(self, button, pressed=True):
        self.gamepad_buttons[button] = pressed

    def touch(self, tid, x, y):
        """Begin / move a touch point (ref: TouchInput Started / Moved)."""
        self.touches[tid % MAX_TOUCHES] = (1.0, x, y)

    def touch_end(self, tid):
        self.touches[tid % MAX_TOUCHES, 0] = 0.0


@system(name="process_touch")
def process_touch(fin=Res("frame_input"), t=ResMut("touches")):
    """ref: bevy_input touch.rs Touches + gestures.rs pinch / rotate: phase
    transitions and two-finger gesture deltas from the raw table."""
    cur = fin.touch_points                    # (MAX_TOUCHES, 3)
    active = cur[:, 0] > 0.5
    was = t.pressed
    t.just_pressed = active & ~was
    t.just_released = ~active & was
    pos = cur[:, 1:3]
    # pinch / rotate: the two lowest-id active points (gathered by a (2,)
    # index: a 0-d index would read the device back)
    idx = torch.argsort((~active).to(torch.int32), stable=True)[:2]
    ab = pos.index_select(0, idx)
    two = active.sum(dtype=torch.int32) >= 2
    d = ab[1] - ab[0]
    dist = torch.sqrt(torch.clamp(torch.sum(d * d), min=1e-12))
    ang = torch.atan2(d[1], d[0])
    had_two = t.gesture_valid
    zero = torch.zeros_like(dist)
    t.pinch_delta = torch.where(two & had_two, dist - t.gesture_dist, zero)
    raw = ang - t.gesture_angle
    wrapped = torch.atan2(torch.sin(raw), torch.cos(raw))
    t.rotate_delta = torch.where(two & had_two, wrapped, zero)
    t.gesture_dist = torch.where(two, dist, t.gesture_dist)
    t.gesture_angle = torch.where(two, ang, t.gesture_angle)
    t.gesture_valid = two
    t.pressed = active
    t.position = pos


@system(name="process_keyboard")
def process_keyboard(fin=Res("frame_input"), kb=ResMut("keyboard")):
    new = fin.keys
    kb.just_pressed = new & ~kb.pressed
    kb.just_released = ~new & kb.pressed
    kb.pressed = new


@system(name="process_mouse")
def process_mouse(fin=Res("frame_input"), mouse=ResMut("mouse")):
    new = fin.mouse_buttons
    mouse.just_pressed = new & ~mouse.pressed
    mouse.just_released = ~new & mouse.pressed
    mouse.pressed = new
    mouse.delta = fin.mouse_pos - mouse.position
    mouse.position = fin.mouse_pos
    mouse.scroll = fin.scroll


@system(name="process_gamepad")
def process_gamepad(fin=Res("frame_input"), pad=ResMut("gamepad")):
    newb = fin.gamepad_buttons
    pad.just_pressed = newb & ~pad.pressed
    pad.pressed = newb
    pad.axes = fin.gamepad_axes


class InputPlugin(Plugin):
    """ref: InputPlugin (bevy_input/src/lib.rs) + the winit event bridge.
    `app.input` is the host-side InputState."""

    def build(self, app):
        state = InputState()
        app.input = state
        dev = app.world.device

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        b = torch.bool
        app.register_frame_input("keys", np.zeros(NUM_KEYS, bool),
                                 lambda: state.keys.copy())
        app.register_frame_input("mouse_buttons",
                                 np.zeros(NUM_MOUSE_BUTTONS, bool),
                                 lambda: state.mouse_buttons.copy())
        app.register_frame_input("mouse_pos", np.zeros(2, np.float32),
                                 lambda: state.mouse_pos.copy())
        app.register_frame_input("scroll", np.zeros(2, np.float32),
                                 lambda: state.scroll.copy())
        app.register_frame_input("gamepad_axes",
                                 np.zeros(NUM_GAMEPAD_AXES, np.float32),
                                 lambda: state.gamepad_axes.copy())
        app.register_frame_input("gamepad_buttons",
                                 np.zeros(NUM_GAMEPAD_BUTTONS, bool),
                                 lambda: state.gamepad_buttons.copy())
        app.insert_resource("keyboard", {
            "pressed": zeros(NUM_KEYS, b),
            "just_pressed": zeros(NUM_KEYS, b),
            "just_released": zeros(NUM_KEYS, b),
        })
        app.insert_resource("mouse", {
            "pressed": zeros(NUM_MOUSE_BUTTONS, b),
            "just_pressed": zeros(NUM_MOUSE_BUTTONS, b),
            "just_released": zeros(NUM_MOUSE_BUTTONS, b),
            "position": zeros(2),
            "delta": zeros(2),
            "scroll": zeros(2),
        })
        app.register_frame_input(
            "touch_points", np.zeros((MAX_TOUCHES, 3), np.float32),
            lambda: state.touches.copy())
        app.insert_resource("touches", {
            "pressed": zeros(MAX_TOUCHES, b),
            "just_pressed": zeros(MAX_TOUCHES, b),
            "just_released": zeros(MAX_TOUCHES, b),
            "position": zeros((MAX_TOUCHES, 2)),
            "pinch_delta": zeros(()),
            "rotate_delta": zeros(()),
            "gesture_dist": zeros(()),
            "gesture_angle": zeros(()),
            "gesture_valid": zeros((), b),
        })
        app.insert_resource("gamepad", {
            "pressed": zeros(NUM_GAMEPAD_BUTTONS, b),
            "just_pressed": zeros(NUM_GAMEPAD_BUTTONS, b),
            "axes": zeros(NUM_GAMEPAD_AXES),
        })
        app.add_systems(First, [process_keyboard, process_mouse,
                                process_gamepad, process_touch])
