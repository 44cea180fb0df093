"""Process start to window start: imports, the pipeline, the drive (its
lap renders from the cache, or rendered by a checkout's first run), the
warm-up frames and every graph capture of the warm-up."""


def read(rec):
    return rec.setup_s
