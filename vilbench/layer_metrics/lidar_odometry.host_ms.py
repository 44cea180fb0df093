"""Host ms a delivered scan in the odometry (GLOBAL_TIMERS
"lidar_odometry": the step's replay and the pose read, which waits for it),
over the window."""


def read(rec):
    t = rec.timers.get("lidar_odometry")
    if not t or not rec.delivered:
        return None
    return 1e3 * t["total_s"] / rec.delivered
