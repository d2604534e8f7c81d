"""The window's requests per micro-batch over `max_batch`, in %, from the
engine's counters (`ServingEngine.stats`) read at the window's ends."""


def read(r):
    if not r.get("batches"):
        return None
    return 100.0 * r["batch_requests"] / r["batches"] / r["max_batch"]
