"""idle_share.batch: per cent of the traced call of the directory server
in which the device ran nothing, read as ``idle_share`` reads a session's
window."""

from benchmark import spec

read = spec.reader("idle_share")
