r"""Seconds from the process's start to the window's opening: imports, the
CUDA context, the kernel libraries (built on a checkout's first run, loaded
afterwards), the weights, the traffic, warm-up, and for serving the server
and the client processes."""


def read(m):
    return m.setup_s
