"""The plain reference, its literal oracle, the control and the judge. They
import nothing of the port and take nothing it made."""
