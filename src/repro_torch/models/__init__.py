"""Model code of the port: common blocks, paged attention, the mixer
registry, the paged serving steps and the weight bridge."""
