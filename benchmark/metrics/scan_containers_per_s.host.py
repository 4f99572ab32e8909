"""scan_containers_per_s.host: the containers of every scan in the window
over the window, from the first scan's start to the last one's end (the
rate a cron job right-sizes the fleet at, on the host's clock)."""


def read(run):
    return run.containers * len(run.scans) / run.window_seconds
