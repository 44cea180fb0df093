"""Host ms a delivered scan in the odometry's blocking pose read
(GLOBAL_TIMERS "lidar_odometry.pose_read", inside "lidar_odometry": the
wait for the step's replay and the pose's copy to the host), over the
window."""


def read(rec):
    t = rec.timers.get("lidar_odometry.pose_read")
    if not t or not rec.delivered:
        return None
    return 1e3 * t["total_s"] / rec.delivered
