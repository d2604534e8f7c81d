"""Requests whose edited image was assembled inside the window, over the
window's seconds."""


def read(r):
    if "completed" not in r:
        return None
    return r["completed"] / r["window_s"]
