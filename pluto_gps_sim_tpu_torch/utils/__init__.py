# Host-side utilities (numpy and ctypes, no torch): native ring-writer
# bindings (utils.native) and the software GPS receiver
# (utils.receiver/acquisition/lnav_decode), copied from the JAX package.
