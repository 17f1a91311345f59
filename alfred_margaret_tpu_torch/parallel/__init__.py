from .shard import DistributedAcEngine, Mesh, StagedMeshCorpus, init_distributed, make_mesh

__all__ = ["DistributedAcEngine", "Mesh", "StagedMeshCorpus", "init_distributed", "make_mesh"]
