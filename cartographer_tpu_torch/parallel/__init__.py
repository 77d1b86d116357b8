"""Multi-rank backend: the sharded loop-closure search and SPA solves over
torch.distributed (partition, sharded, multihost)."""
