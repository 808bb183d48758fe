from vidsgg_torch.data.entry import Entry, EntryCapacity

__all__ = ["Entry", "EntryCapacity"]
