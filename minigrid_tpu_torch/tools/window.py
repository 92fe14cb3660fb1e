"""Matplotlib display window — parity with the reference's `window.py`
(~110 LoC): image display, caption, key-press handler, blocking show (a
copy of `minigrid_tpu/tools/window.py`; matplotlib loads when a window
opens), and `ScriptedWindow`, the same interface without a display."""

from __future__ import annotations

from types import SimpleNamespace


class Window:
    def __init__(self, title: str):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig, self.ax = plt.subplots()
        self.fig.canvas.manager.set_window_title(title)
        self.imshow_obj = None
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        self.closed = False

        def close_handler(evt):
            self.closed = True

        self.fig.canvas.mpl_connect("close_event", close_handler)

    def show_img(self, img):
        if self.imshow_obj is None:
            self.imshow_obj = self.ax.imshow(img, interpolation="bilinear")
        else:
            self.imshow_obj.set_data(img)
        self.fig.canvas.draw()
        self.plt.pause(0.001)

    def set_caption(self, text: str):
        self.ax.set_xlabel(text)

    def reg_key_handler(self, key_handler):
        self.fig.canvas.mpl_connect("key_press_event", key_handler)

    def show(self, block: bool = True):
        if not block:
            self.plt.ion()
        self.plt.show(block=block)

    def close(self):
        self.plt.close(self.fig)
        self.closed = True


class ScriptedWindow:
    """A window without a display or matplotlib: it records the captions
    and images it is shown, and `show()` presses `keys` in order through
    the registered handler (a matplotlib key event's `.key`), stopping once
    the window is closed. It drives `manual_control` headless."""

    def __init__(self, title: str, keys=()):
        self.title = title
        self.keys = list(keys)
        self.captions = []
        self.frames = []
        self.closed = False
        self._handler = None

    def show_img(self, img):
        self.frames.append(img)

    def set_caption(self, text: str):
        self.captions.append(text)

    def reg_key_handler(self, key_handler):
        self._handler = key_handler

    def show(self, block: bool = True):
        for key in self.keys:
            if self.closed:
                break
            self._handler(SimpleNamespace(key=key))

    def close(self):
        self.closed = True
