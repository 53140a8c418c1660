"""Multi-object tracking: the SORT tracker over frame blocks
(:mod:`.tracker`) and host-side trajectory assembly (:mod:`.assemble`)."""
from facerec_torch.track.tracker import (TrackEmit, TrackerConfig,
                                         TrackerState, init_tracker,
                                         run_block)
from facerec_torch.track.assemble import TrajectoryAssembler
