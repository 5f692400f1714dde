"""Generator kinds: how a traffic mix's calls are scheduled.  A traffic
file names one by its module (``"generator": "closed"``)."""
