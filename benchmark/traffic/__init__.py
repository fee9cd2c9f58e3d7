"""Traffic mixes (<mix>.json) and the driver of each kind (<kind>.py)."""
