"""Scene build: host clock around Scene.build / build_two_level and the
pipeline's attach, ended by a synchronise."""


def read(ctx):
    return ctx["scene_build_s"]
