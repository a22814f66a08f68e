"""IGS monitoring-station catalog for RINEX FTP fetch.

A copy of the JAX package's ``ingest/stations.py:1-109``.

Same station set as the reference (plutogpssim.h:190-285): 3 stations
publishing RINEX v3 and 84 publishing RINEX v2, each with its
4-character and 9-character ID and human-readable name.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["Station", "STATIONS_V2", "STATIONS_V3"]


class Station(NamedTuple):
    id_v2: str
    id_v3: str
    name: str


STATIONS_V3 = (
    Station("func", "FUNC00PRT", "Funchal"),
    Station("flrs", "FLRS00PRT", "Santa Cruz das Flore"),
    Station("pdel", "PDEL00PRT", "PONTA DELGADA"),
)

STATIONS_V2 = (
    Station("abmf", "ABMF00GLP", "Aeroport du Raizet"),
    Station("aggo", "AGGO00ARG", "AGGO"),
    Station("ajac", "AJAC00FRA", "Ajaccio"),
    Station("ankr", "ANKR00TUR", "Ankara"),
    Station("areg", "AREG00PER", "Arequipa"),
    Station("ascg", "ASCG00SHN", "Ascension"),
    Station("bogi", "BOGI00POL", "Borowa Gora"),
    Station("bor1", "BOR100POL", "Borowiec"),
    Station("brst", "BRST00FRA", "Brest"),
    Station("chpg", "CHPG00BRA", "Cachoeira Paulista"),
    Station("cibg", "CIBG00IDN", "Cibinong"),
    Station("cpvg", "CPVG00CPV", "CAP-VERT"),
    Station("djig", "DJIG00DJI", "Djibouti"),
    Station("dlf1", "DLF100NLD", "Delft"),
    Station("ffmj", "FFMJ00DEU", "Frankfurt/Main"),
    Station("ftna", "FTNA00WLF", "Futuna"),
    Station("gamb", "GAMB00PYF", "Rikitea"),
    Station("gamg", "GAMG00KOR", "Geochang"),
    Station("glps", "GLPS00ECU", "Galapagos Permanent Station"),
    Station("glsv", "GLSV00UKR", "Kiev/Golosiiv"),
    Station("gmsd", "GMSD00JPN", "GUTS Masda"),
    Station("gop6", "GOP600CZE", "Pecny, Ondrejov"),
    Station("gop7", "GOP700CZE", "Pecny, Ondrejov"),
    Station("gope", "GOPE00CZE", "Pecny, Ondrejov"),
    Station("grac", "GRAC00FRA", "Grasse"),
    Station("gras", "GRAS00FRA", "Observatoire de Calern - OCA"),
    Station("holb", "HOLB00CAN", "Holberg"),
    Station("hueg", "HUEG00DEU", "Huegelheim"),
    Station("ieng", "IENG00ITA", "Torino"),
    Station("ista", "ISTA00TUR", "Istanbul"),
    Station("izmi", "IZMI00TUR", "Izmir"),
    Station("jfng", "JFNG00CHN", "Juifeng"),
    Station("joz2", "JOZ200POL", "Jozefoslaw"),
    Station("joze", "JOZE00POL", "Jozefoslaw"),
    Station("kerg", "KERG00ATF", "Kerguelen Islands"),
    Station("kitg", "KITG00UZB", "Kitab"),
    Station("koug", "KOUG00GUF", "Kourou"),
    Station("krgg", "KRGG00ATF", "Kerguelen Islands"),
    Station("krs1", "KRS100TUR", "Kars"),
    Station("lama", "LAMA00POL", "Lamkowo"),
    Station("leij", "LEIJ00DEU", "Leipzig"),
    Station("lmmf", "LMMF00MTQ", "Aeroport Aime CESAIRE-LE LAMENTIN"),
    Station("lroc", "LROC00FRA", "La Rochelle"),
    Station("mad2", "MAD200ESP", "Madrid Deep Space Tracking Station"),
    Station("madr", "MADR00ESP", "Madrid Deep Space Tracking Station"),
    Station("mayg", "MAYG00MYT", "Dzaoudzi"),
    Station("mers", "MERS00TUR", "Mersin"),
    Station("mikl", "MIKL00UKR", "Mykolaiv"),
    Station("morp", "MORP00GBR", "Morpeth"),
    Station("nklg", "NKLG00GAB", "N'KOLTANG"),
    Station("nyal", "NYAL00NOR", "Ny-Alesund"),
    Station("nya1", "NYA100NOR", "Ny-Alesund"),
    Station("ohi2", "OHI200ATA", "O'Higgins"),
    Station("orid", "ORID00MKD", "Ohrid"),
    Station("owmg", "OWMG00NZL", "Chatham Island"),
    Station("polv", "POLV00UKR", "Poltava"),
    Station("ptbb", "PTBB00DEU", "Braunschweig"),
    Station("ptgg", "PTGG00PHL", "Manilla"),
    Station("rabt", "RABT00MAR", "Rabat, EMI"),
    Station("reun", "REUN00REU", "La Reunion - Observatoire Volcanologique"),
    Station("rgdg", "RGDG00ARG", "Rio Grande"),
    Station("riga", "RIGA00LVA", "RIGA permanent GPS"),
    Station("seyg", "SEYG00SYC", "Mahe"),
    Station("sofi", "SOFI00BGR", "Sofia"),
    Station("stj3", "STJ300CAN", "STJ3 CACS-GSD"),
    Station("sulp", "SULP00UKR", "Lviv Polytechnic"),
    Station("svtl", "SVTL00RUS", "Svetloe"),
    Station("tana", "TANA00ETH", "ILA, Bahir Dar University"),
    Station("thtg", "THTG00PYF", "Papeete Tahiti"),
    Station("thti", "THTI00PYF", "Tahiti"),
    Station("tit2", "TIT200DEU", "Titz / Jackerath"),
    Station("tlse", "TLSE00FRA", "Toulouse"),
    Station("tro1", "TRO100NOR", "Tromsoe"),
    Station("warn", "WARN00DEU", "Warnemuende"),
    Station("whit", "WHIT00CAN", "WHIT CACS-GSD"),
    Station("wroc", "WROC00POL", "Wroclaw"),
    Station("wtza", "WTZA00DEU", "Wettzell"),
    Station("yel2", "YEL200CAN", "Yellow Knife"),
    Station("zeck", "ZECK00RUS", "Zelenchukskaya"),
    Station("zim2", "ZIM200CHE", "Zimmerwald"),
    Station("zimm", "ZIMM00CHE", "Zimmerwald L+T 88"),
)
