"""``map_rounds``: orientation rounds a map request, summed over its chunks:
the program's count of single-orientation solver calls
(``models/pipeline.py`` ``multirot_positionable``'s ``per_round``, one entry
a round), as a mean over the window's requests.  A sweep that packs
orientations or exits early cuts it."""


def read(view):
    if view.kind != "map" or not view.per_request:
        return None
    n = [r["rounds"] for r in view.per_request]
    return sum(n) / len(n)
