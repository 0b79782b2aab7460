"""The images that ``BatchDecoder`` decoded on its "merged" route, over all
images of the window's batches, in %."""


def read(rec):
    if not rec.routes:
        return None
    merged = sum(len(idx) for _, routes in rec.routes
                 for route, idx in routes if route == "merged")
    return merged / sum(n for n, _ in rec.routes) * 100.0
