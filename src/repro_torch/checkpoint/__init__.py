"""npz manifest checkpoints, the reference-to-port weight bridge, and
fleet checkpoints (state snapshots of a server, bit-exact on resume)."""
from repro_torch.checkpoint.io import (load_metadata, load_state,
                                       restore_checkpoint, save_checkpoint,
                                       save_state)
from repro_torch.checkpoint.fleet import (restore_fleet_checkpoint,
                                          restore_server,
                                          save_fleet_checkpoint,
                                          snapshot_server)
