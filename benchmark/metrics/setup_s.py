"""Seconds from the process's start to the window's first request or
step."""


def read(r):
    return r.get("setup_s")
