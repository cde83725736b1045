"""Set-up: process start to the window (imports, scene build, kernel builds
and loads, the warm-up unit), host clock."""


def read(ctx):
    return ctx["setup_s"]
