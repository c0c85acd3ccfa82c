"""The device's idle share of the traced frames of the walk cells: 1 - the
union of the device operations' intervals over the traced frames' span, in
percent."""

from harness import readouts

UNIT = "%"
read = readouts.idle_share_frames
