"""An optional capability whose dependencies are missing."""


class NotAvailableException(Exception):
    """Raised where an optional capability's dependencies are absent (a
    real ``carla`` client, a mesh renderer for SMPL)."""

    def __init__(self, functionality_name: str, optional_group_name: str):
        self.functionality_name = functionality_name
        self.optional_group_name = optional_group_name
        super().__init__(
            f"{functionality_name} is not available; it requires the "
            f"optional '{optional_group_name}' dependencies.")
