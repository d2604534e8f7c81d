"""Training images of the steps taken in the window (the batch size a
step, supervised and episode alike), over the window's seconds, which end
when the card has finished them."""


def read(r):
    if "images" not in r:
        return None
    return r["images"] / r["window_s"]
