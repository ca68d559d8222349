"""``setup_s``: seconds from the process's start to the first timed request:
imports, the card's context, the kernels' build (in a checkout's first
run), the inputs, the program's set-up and one warm request."""


def read(view):
    return view.setup_s
