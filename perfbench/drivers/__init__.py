"""One driver per kind of traffic (the mix's "driver" key): it sets the
port up for the cell, runs the measured window through the port's entry,
and compares what the window produced with the family's reference."""
