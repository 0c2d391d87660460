"""Frames whose pose came back inside the window, over the window's seconds."""


def read(run):
    return len(run.back_in_window()) / run.window_s
