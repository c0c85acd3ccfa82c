"""The fine pass's share of its roofline in the click cells: the least time for
the samples the traced frames' inputs need (the reference's count) over the
traced time of the render kernel's full passes, in percent."""

from harness import readouts

UNIT = "%"
read = readouts.fine_pass_roofline
