"""``setup_s``: seconds from the process's start to the window's start
(imports, the kernels built or loaded, the warm-up study), host clock."""


def value(window):
    return window.setup_s
