"""Host ms a delivered scan in global fusion's backlog wait (GLOBAL_TIMERS
"global_fusion.backlog_wait": models/global_fusion.py waits there, before
it enqueues a keyframe on its own CUDA stream, for the keyframe BACKLOG
back), over the window. A program that bounds that backlog but never
waited reads 0; one without the bound (no GlobalFusion.BACKLOG) reads
nothing."""


def read(rec):
    if not rec.delivered:
        return None
    t = rec.timers.get("global_fusion.backlog_wait")
    if t:
        return 1e3 * t["total_s"] / rec.delivered
    from vil_fusion_tpu_torch.models.global_fusion import GlobalFusion

    return 0.0 if hasattr(GlobalFusion, "BACKLOG") else None
