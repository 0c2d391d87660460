"""Distribution over ``torch.distributed``: the landmark-sharded bundle
adjustment (``dist_ba``) and the cross-process keyframe handoff and process
group (``multihost``)."""
