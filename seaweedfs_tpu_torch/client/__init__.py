from .master_client import MasterClient
from .operation import assign, delete_file, lookup, upload_data, submit_file

__all__ = ["MasterClient", "assign", "delete_file", "lookup", "upload_data", "submit_file"]
